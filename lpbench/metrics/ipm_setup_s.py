"""ipm_setup_s: the IPM's set-up seconds a solve,
`getTimer().read("ipm_setup")`, averaged over the solves that the IPM
answered."""


def read(run):
    def one(c):
        api = c["api"]
        if "info" not in api or api["info"].ipm_iteration_count <= 0:
            return None
        return api["timer"].read("ipm_setup")
    return run.mean(one)
