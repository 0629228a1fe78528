"""pdlp_iterations: PDHG iterations a solve,
`getInfo().pdlp_iteration_count`, averaged over the solves that PDLP
answered."""


def read(run):
    def one(c):
        info = c["api"].get("info")
        if info is None or info.pdlp_iteration_count <= 0:
            return None
        return info.pdlp_iteration_count
    return run.mean(one)
