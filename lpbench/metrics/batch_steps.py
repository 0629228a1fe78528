"""batch_steps: the batched PDHG steps a call ran, the largest of the
returned `PdlpRunInfo.iterations` (every instance steps until the last
one converges), averaged over the calls."""


def read(run):
    def one(c):
        results = c["api"].get("results")
        if not results:
            return None
        return max(info.iterations for _, info in results)
    return run.mean(one)
