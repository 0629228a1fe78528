"""pdhg_step_ms: the PDHG rounds' wall ms a step, `getTimer()`'s
`pdlp_round` seconds over `getInfo().pdlp_iteration_count`, averaged
over the solves that PDLP answered."""


def read(run):
    def one(c):
        api = c["api"]
        if "info" not in api or api["info"].pdlp_iteration_count <= 0:
            return None
        return 1e3 * api["timer"].read("pdlp_round") / \
            api["info"].pdlp_iteration_count
    return run.mean(one)
