"""Basic usage: solve a 2-D Poisson problem with 4 overlapping subdomains.

    python -m schwarz_tpu_torch.examples.poisson_basic [--device cpu]
"""

from schwarz_tpu_torch import Settings, generate_rhs, laplacian_2d, solve

SETTINGS = Settings(overlap=4, tolerance=1e-8, max_iters=300)


def main(device=None):
    A = laplacian_2d(64)                 # 4096 x 4096 five-point stencil
    b = generate_rhs(A.n)
    result = solve(A, b, SETTINGS, num_subdomains=4, device=device)
    print(f"converged={result.converged} in {result.iters} outer iterations")
    print(f"true relative residual: {result.relative_residual_norm:.3e}")
    return result


if __name__ == "__main__":
    from schwarz_tpu_torch.examples import device_from_args

    main(device_from_args(__doc__))
