"""The ``local_solve`` stage's share of an instrumented run's loop
(``RASolver.run_instrumented``: each stage synchronized and timed on the
host clock), over the run's instrumented solves, kept apart from the
window and the profiled stretch since the per-stage syncs perturb the
timing."""


def read(ctx):
    runs = [i for i in (ctx.instrumented or []) if i.get("stage_timings")
            and "local_solve" in i["stage_timings"]]
    loop = sum(i["loop_s"] for i in runs)
    if not runs or loop <= 0:
        return None
    return 100 * sum(i["stage_timings"]["local_solve"]["total"]
                     for i in runs) / loop
