"""qp_factor_ms: the QP IPM's ms an iteration in its dense factors,
`getTimer()`'s clocks `qp_factor_q` (Q + Dx) and `qp_factor_m` (the
Schur complement), and `qp_factor_kkt` (the LU of the reduced KKT
matrix, in a repaired pass), over `getInfo().qp_iteration_count`,
averaged over the solves that the QP IPM answered (CUDA events on the
card). A clock the program does not have reads 0."""

CLOCKS = ("qp_factor_q", "qp_factor_m", "qp_factor_kkt")


def read(run):
    def one(c):
        api = c["api"]
        if "info" not in api or api["info"].qp_iteration_count <= 0:
            return None
        seconds = sum(api["timer"].read(name) for name in CLOCKS)
        return 1e3 * seconds / api["info"].qp_iteration_count
    return run.mean(one)
