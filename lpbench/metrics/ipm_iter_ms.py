"""ipm_iter_ms: the IPM's wall ms an iteration, `getTimer()`'s
`ipm_iterations` seconds over `getInfo().ipm_iteration_count`, averaged
over the solves that the IPM answered."""


def read(run):
    def one(c):
        api = c["api"]
        if "info" not in api or api["info"].ipm_iteration_count <= 0:
            return None
        return 1e3 * api["timer"].read("ipm_iterations") / \
            api["info"].ipm_iteration_count
    return run.mean(one)
