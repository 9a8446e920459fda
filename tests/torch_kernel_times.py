"""K4-K7 on the card at ``chip_smoke.py``'s single-process shapes, for the
package of one checkout, so that two commits can be timed in turns on one
card:

    python tests/torch_kernel_times.py ROOT TAG

imports ``schwarz_tpu_torch`` from the checkout at ROOT (its kernels built
into ROOT/build/torch_kernels/), and the shapes (``SLICE``,
``_slice_free_settings``) and the timer from the ``chip_smoke.py`` beside
this script, and prints one line,
``TIMES {"tree": TAG, "K4": ms, "K5": ms, "K6": ms, "K7": ms}``: K4 one put
exchange of the synchronous slice's plan (``laplacian_2d(1024)``, 16
subdomains on 16 ranks, float32, 50 launches), K5 one 16-round launch of
the 1-D slice (``laplacian_3d(100)``, 16 ranks), K6 of the 2-D slice
(``laplacian_2d(1024)``, 4 x 4), K7 of the general slice
(``anisotropic_diffusion_2d(360)``, METIS into 128), each the mean of CUDA
events around each launch after a read flush of L2 (``chip_smoke.Smoke.ms``,
5 launches).  Compare two commits within one call, in turns (parent,
change, change, parent).  Card only.
"""

import importlib.util
import json
import os
import sys

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from schwarz_tpu_torch import (CommSettings, HaloStrategy,  # noqa: E402
                               Partition, Precond, RASolver, Settings)
from schwarz_tpu_torch.core.decompose import decompose  # noqa: E402
from schwarz_tpu_torch.core.partition import make_partition  # noqa: E402
from schwarz_tpu_torch.models import (anisotropic_diffusion_2d,  # noqa: E402
                                      generate_rhs, laplacian_2d,
                                      laplacian_3d)
from schwarz_tpu_torch.ops import cuda_build  # noqa: E402
from schwarz_tpu_torch.ops.async_ras_kernel import (  # noqa: E402
    async_ras_rounds)
from schwarz_tpu_torch.ops.rdma_kernel import (  # noqa: E402
    rdma_exchange_launch)
from schwarz_tpu_torch.ras import make_free_running_solver  # noqa: E402


def main(tag: str) -> None:
    cuda_build.build_all()
    sm = cs.Smoke(torch)
    out = {"tree": tag}
    A = laplacian_2d(1024)
    s = Settings(precond=Precond.jacobi, **cs.SLICE,
                 comm=CommSettings(strategy=HaloStrategy.rdma,
                                   enable_put=True, enable_get=False))
    solver = RASolver(decompose(A, generate_rhs(A.n, random=False), s, 16),
                      num_ranks=16)
    solver.run()
    x = torch.zeros((16, solver.meta.max_interior), dtype=torch.float32,
                    device="cuda")
    out["K4"] = sm.ms(lambda: rdma_exchange_launch(x, solver._rounds, None,
                                                   "put"), 50)
    fr = cs._slice_free_settings()
    A3 = laplacian_3d(100)
    s5, _ = make_free_running_solver(A3, np.ones(A3.n), 16, fr)
    p, d, D = s5.plan, s5._dev, s5.D
    x0, known, aux, hl, hr = s5.init_state()
    args = (d["dia"], d["b"], d["dinv"], d["mask_dom"], d["mask_int"],
            x0.reshape(D, -1), known, aux, hl, hr, d.get("boost"))
    kw = dict(offsets=p.offsets, total=p.total, hw=p.hw,
              rounds=s5.chunk_rounds, staleness=s5.staleness,
              ninner=s5.ninner, tol=s5.tolerance)
    out["K5"] = sm.ms(lambda: async_ras_rounds(*args, **kw), 5)
    s6, _ = make_free_running_solver(A, np.ones(A.n), 16, fr)
    X, kn, ax = s6.init_state()
    xf = s6._fold(X)
    out["K6"] = sm.ms(lambda: s6.launch(xf, kn, ax), 5)
    Aa = anisotropic_diffusion_2d(360, eps=5.0, theta=0.3)
    frm = fr.replace(partition=Partition.metis)
    s7, _ = make_free_running_solver(
        Aa, np.ones(Aa.n), 128, frm,
        partition_indices=make_partition(Aa, 128, frm))
    state = s7.init_state()
    out["K7"] = sm.ms(lambda: s7.launch(*state), 5)
    print("TIMES " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[2])
