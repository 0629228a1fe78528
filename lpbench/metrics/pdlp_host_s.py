"""pdlp_host_s: the PDLP wrapper's seconds a solve outside its PDHG
rounds (set-up, the refinement's host oracle, recovery):
`getRunData().solve_time` less `getTimer().read("pdlp_round")`, averaged
over the solves that PDLP answered."""


def read(run):
    def one(c):
        api = c["api"]
        if "info" not in api or api["info"].pdlp_iteration_count <= 0:
            return None
        return api["run_data"].solve_time - api["timer"].read("pdlp_round")
    return run.mean(one)
