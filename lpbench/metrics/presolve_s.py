"""presolve_s: presolve's seconds a solve, `getRunData().presolve_time`
(layer: presolve), averaged over the facade's solves."""


def read(run):
    return run.mean(lambda c: c["api"]["run_data"].presolve_time
                    if "run_data" in c["api"] else None)
