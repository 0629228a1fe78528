"""qp_iterations: the QP IPM's iterations a solve,
`getInfo().qp_iteration_count`, averaged over the solves that the QP IPM
answered."""


def read(run):
    def one(c):
        api = c["api"]
        if "info" not in api or api["info"].qp_iteration_count <= 0:
            return None
        return api["info"].qp_iteration_count
    return run.mean(one)
