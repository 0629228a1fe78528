"""pdhg_block_ms: the PDHG blocks' wall ms a step: the program's span
"highs.pdhg.block" (a block's replays, or its ops, and the host read of
its metrics) less the graph captures inside the blocks
("highs.pdhg.capture"), over the traced window, divided by the steps of
the solves that PDLP answered (`getInfo().pdlp_iteration_count`).
Unlike `pdhg_step_ms`, it leaves out the rounds' host work between the
blocks: the power method, the restarts, the refinement's oracle and
the final unscale."""

from lpbench import spans


def read(run):
    block = spans.seconds(run, "pdhg.block")
    steps = sum(c["api"]["info"].pdlp_iteration_count
                for c in spans.pdlp_solves(run))
    if block is None or steps <= 0:
        return None
    return 1e3 * (block - (spans.seconds(run, "pdhg.capture") or 0.0)) / \
        steps
