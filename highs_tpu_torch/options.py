"""Typed option registry.

Re-implements the behavior of the reference option system
(highs/lp_data/HighsOptions.h:29-124 OptionRecord classes, :335-520 struct)
as a Python registry: every option has a name, type, default, bounds and
description, is introspectable, and can be read from a HiGHS-style options
file (io/LoadOptions.cpp behavior).  Option names and defaults follow the
reference (docs/src/options/definitions.md) so existing HiGHS options files
and scripts keep working.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

from .constants import HighsStatus, kHighsIInf, kHighsInf


@dataclasses.dataclass
class OptionRecord:
    name: str
    type: type  # bool, int, float, str
    default: Any
    description: str = ""
    minimum: Optional[float] = None
    maximum: Optional[float] = None
    advanced: bool = False
    choices: Optional[List[str]] = None  # for string options with fixed set

    def validate(self, value: Any):
        """Return (HighsStatus, coerced_value)."""
        if self.type is bool:
            if isinstance(value, bool):
                return HighsStatus.kOk, value
            if isinstance(value, str):
                v = value.strip().lower()
                if v in ("true", "t", "1", "on"):
                    return HighsStatus.kOk, True
                if v in ("false", "f", "0", "off"):
                    return HighsStatus.kOk, False
                return HighsStatus.kError, None
            if isinstance(value, (int, float)) and value in (0, 1):
                return HighsStatus.kOk, bool(value)
            return HighsStatus.kError, None
        if self.type is int:
            if isinstance(value, bool) or not isinstance(value, (int, float, str)):
                return HighsStatus.kError, None
            try:
                fv = float(value)
            except ValueError:
                return HighsStatus.kError, None
            if fv != int(fv):
                return HighsStatus.kError, None
            iv = int(fv)
            if self.minimum is not None and iv < self.minimum:
                return HighsStatus.kError, None
            if self.maximum is not None and iv > self.maximum:
                return HighsStatus.kError, None
            return HighsStatus.kOk, iv
        if self.type is float:
            try:
                fv = float(value)
            except (TypeError, ValueError):
                return HighsStatus.kError, None
            if self.minimum is not None and fv < self.minimum:
                return HighsStatus.kError, None
            if self.maximum is not None and fv > self.maximum:
                return HighsStatus.kError, None
            return HighsStatus.kOk, fv
        # string
        if not isinstance(value, str):
            return HighsStatus.kError, None
        return HighsStatus.kOk, value


_REGISTRY: List[OptionRecord] = []


def _opt(name, type_, default, desc="", lo=None, hi=None, advanced=False,
         choices=None):
    _REGISTRY.append(OptionRecord(name, type_, default, desc, lo, hi,
                                  advanced, choices))


# --- run-time options (reference defaults: docs/src/options/definitions.md) --
_opt("presolve", str, "choose", "Presolve option: off / choose / on")
_opt("solver", str, "choose",
     "Solver option: simplex / choose / ipm / pdlp / hipdlp / ipx / hipo")
_opt("parallel", str, "choose", "Parallel option: off / choose / on")
_opt("run_crossover", str, "on",
     "Run IPM crossover: off / choose / on")
_opt("time_limit", float, kHighsInf, "Time limit (seconds)", 0.0, kHighsInf)
_opt("threads", int, 0, "Number of threads used by HiGHS (0: automatic)", 0)
_opt("ranging", str, "off", "Compute cost/bound/RHS ranging: off / on")
_opt("random_seed", int, 0, "Random seed used in HiGHS", 0)

_opt("infinite_cost", float, 1e20,
     "Limit on |cost| considered infinite", 1e15, kHighsInf)
_opt("infinite_bound", float, 1e20,
     "Limit on |bound| considered infinite", 1e15, kHighsInf)
_opt("small_matrix_value", float, 1e-9,
     "Lower limit on |matrix entries|", 1e-12, kHighsInf)
_opt("large_matrix_value", float, 1e15,
     "Upper limit on |matrix entries|", 1.0, kHighsInf)
_opt("kkt_tolerance", float, 1e-7,
     "General KKT tolerance; cascades into feasibility/optimality "
     "tolerances when changed", 1e-10, kHighsInf)
_opt("primal_feasibility_tolerance", float, 1e-7,
     "Primal feasibility tolerance", 1e-10, kHighsInf)
_opt("dual_feasibility_tolerance", float, 1e-7,
     "Dual feasibility tolerance", 1e-10, kHighsInf)
_opt("primal_residual_tolerance", float, 1e-7,
     "Primal residual tolerance", 1e-10, kHighsInf)
_opt("dual_residual_tolerance", float, 1e-7,
     "Dual residual tolerance", 1e-10, kHighsInf)
_opt("optimality_tolerance", float, 1e-7,
     "Relative gap optimality tolerance", 1e-10, kHighsInf)
_opt("objective_bound", float, kHighsInf,
     "Objective bound for termination of the dual simplex solver")
_opt("objective_target", float, -kHighsInf,
     "Objective target for termination of the MIP solver")
_opt("user_objective_scale", int, 0, "Exponent of power-of-two objective scale")
_opt("user_bound_scale", int, 0, "Exponent of power-of-two bound scale")
_opt("highs_debug_level", int, 0, "Debug level", 0, 3)
_opt("highs_analysis_level", int, 0, "Analysis level bitmask", 0, 511)

# --- simplex ---------------------------------------------------------------
_opt("simplex_strategy", int, 1,
     "Simplex strategy: 0=choose 1=dual(serial) 2=dual(PAMI) 3=dual(SIP) "
     "4=primal", 0, 4)
_opt("simplex_scale_strategy", int, 2,
     "Simplex scaling: 0=off 1=choose 2=equilibration 3=forced equilibration "
     "4=max value", 0, 4)
_opt("simplex_crash_strategy", int, 0, "Simplex crash strategy", 0, 9)
_opt("simplex_dual_edge_weight_strategy", int, -1,
     "Dual edge weight strategy: -1=choose 0=Dantzig 1=Devex 2=steepest edge",
     -1, 2)
_opt("simplex_primal_edge_weight_strategy", int, -1,
     "Primal edge weight strategy: -1=choose 0=Dantzig 1=Devex 2=steepest "
     "edge", -1, 2)
_opt("simplex_iteration_limit", int, kHighsIInf, "Simplex iteration limit", 0)
_opt("simplex_update_limit", int, 5000,
     "Limit on basis updates before refactorization", 0)
_opt("simplex_min_concurrency", int, 1,
     "Minimum concurrency for parallel simplex", 1, 8)
_opt("simplex_max_concurrency", int, 8,
     "Maximum concurrency for parallel simplex", 1, 8)

# --- logging ---------------------------------------------------------------
_opt("output_flag", bool, True, "Enables or disables solver output")
_opt("log_to_console", bool, True, "Log to console")
_opt("log_file", str, "", "Log file")
_opt("timeless_log", bool, False, "Suppression of time-based output")
_opt("log_dev_level", int, 0, "Developer logging level", 0, 3)
_opt("log_githash", bool, True, "Log git hash", advanced=True)

# --- files -----------------------------------------------------------------
_opt("read_solution_file", str, "", "Solution file to read")
_opt("read_basis_file", str, "", "Basis file to read")
_opt("write_model_file", str, "", "Model file to write")
_opt("solution_file", str, "", "Solution file to write")
_opt("write_basis_file", str, "", "Basis file to write")
_opt("write_model_to_file", bool, False, "Write model to file")
_opt("write_presolved_model_to_file", bool, False, "Write presolved model")
_opt("write_presolved_model_file", str, "", "Presolved model file to write")
_opt("write_iis_model_file", str, "", "IIS model file to write")
_opt("write_solution_to_file", bool, False, "Write primal/dual solution")
_opt("write_solution_style", int, 0,
     "Solution style: -1=old raw 0=raw 1=pretty 2=glpsol raw 3=glpsol pretty "
     "4=sparse", -1, 4)
_opt("glpsol_cost_row_location", int, 0, "Location of cost row for glpsol",
     -2)

# --- IPM -------------------------------------------------------------------
_opt("ipm_optimality_tolerance", float, 1e-8, "IPM optimality tolerance",
     1e-12, kHighsInf)
_opt("ipm_iteration_limit", int, kHighsIInf, "IPM iteration limit", 0)
_opt("hipo_system", str, "choose",
     "KKT system for hipo IPM: augmented / normaleq / choose")
_opt("hipo_parallel_type", str, "both",
     "Parallelism in hipo IPM: none / tree / node / both")
_opt("hipo_ordering", str, "choose",
     "Fill-reducing ordering: metis / amd / rcm / choose")
_opt("hipo_block_size", int, 128, "Block size in hipo factorization", 1)
_opt("run_centring", bool, False, "Run IPM to compute analytic centre",
     advanced=True)
_opt("max_centring_steps", int, 100,
     "Maximum number of steps for IPM analytic-centre run", 0, advanced=True)
_opt("centring_ratio_tolerance", float, 100.0,
     "Tolerance on centring ratio xi*zi", 0.0, advanced=True)

# --- PDLP ------------------------------------------------------------------
_opt("pdlp_features_off", int, 0, "Bitmask of PDLP features to switch off", 0)
_opt("pdlp_iteration_limit", int, kHighsIInf, "PDLP iteration limit", 0)
_opt("pdlp_scaling_mode", int, 5,
     "PDLP scaling mode bitmask: 1=Ruiz 2=Pock-Chambolle 4=L2", 0, 7)
_opt("pdlp_ruiz_iterations", int, 10, "Ruiz equilibration iterations", 0)
_opt("pdlp_restart_strategy", int, 2,
     "PDLP restart strategy: 0=none 1=fixed 2=adaptive(Halpern)", 0, 3)
_opt("pdlp_cupdlpc_restart_method", int, 1,
     "cuPDLP-C style restart method", 0, 2)
_opt("pdlp_step_size_strategy", int, 1,
     "PDLP step-size strategy: 0=fixed 1=adaptive 2=Malitsky-Pock", 0, 2)
_opt("pdlp_optimality_tolerance", float, 1e-7,
     "PDLP relative optimality tolerance", 1e-12, kHighsInf)

# --- QP --------------------------------------------------------------------
_opt("qp_allow_hot_start", bool, False, "Allow hot start in QP solver")
_opt("qp_iteration_limit", int, kHighsIInf, "QP iteration limit", 0)
_opt("qp_nullspace_limit", int, 4000, "QP nullspace dimension limit", 0)
_opt("qp_regularization_value", float, 1e-7, "QP regularization", 0.0)

# --- IIS / multi-objective -------------------------------------------------
_opt("iis_strategy", int, 0, "IIS strategy bitmask", 0, 31)
_opt("iis_time_limit", float, kHighsInf, "IIS time limit", 0.0)
_opt("blend_multi_objectives", bool, True,
     "Blend multiple objectives (true) or lexicographic (false)")

# --- advanced --------------------------------------------------------------
_opt("solve_relaxation", bool, False, "Solve the LP relaxation of a MIP",
     advanced=True)
_opt("allow_unbounded_or_infeasible", bool, False,
     "Return kUnboundedOrInfeasible rather than distinguishing",
     advanced=True)
_opt("use_implied_bounds_from_presolve", bool, False, "", advanced=True)
_opt("mps_parser_type_free", bool, True,
     "Use free-format MPS parsing", advanced=True)
_opt("use_warm_start", bool, True, "Use warm start if available",
     advanced=True)
_opt("keep_n_rows", int, -1,
     "Handling of free rows in MPS read: -1=delete 0=keep as free 1=keep",
     -1, 1, advanced=True)
_opt("ipx_dualize_strategy", int, 0, "IPX dualization strategy", -1, 3,
     advanced=True)
_opt("simplex_dualize_strategy", int, 0, "Simplex dualization strategy",
     -1, 1, advanced=True)
_opt("simplex_permute_strategy", int, -1, "Simplex permutation strategy",
     -1, 1, advanced=True)
_opt("simplex_price_strategy", int, 3, "Simplex PRICE strategy", 0, 3,
     advanced=True)
_opt("presolve_reduction_limit", int, -1,
     "Limit on presolve reductions (-1: no limit)", -1, advanced=True)
_opt("restart_presolve_reduction_limit", int, -1,
     "Limit on presolve reductions in MIP restart", -1, advanced=True)
_opt("presolve_substitution_maxfillin", int, 10,
     "Maximal fillin for presolve substitutions", 0, advanced=True)
_opt("presolve_rule_off", int, 0, "Bitmask of presolve rules to disable", 0,
     advanced=True)
_opt("presolve_aggregator", bool, False,
     "Enable implied-free column aggregation (HPresolve::aggregator "
     "role); off by default: measured net loss for this stack's "
     "simplex", advanced=True)
_opt("presolve_rule_logging", bool, False, "Log presolve rule use",
     advanced=True)
_opt("presolve_remove_slacks", bool, False, "Remove slack variables",
     advanced=True)
_opt("factor_pivot_threshold", float, 0.1, "LU pivot threshold", 8e-4, 0.5,
     advanced=True)
_opt("factor_pivot_tolerance", float, 1e-10, "LU pivot tolerance", 0.0,
     advanced=True)
_opt("start_crossover_tolerance", float, 1e-8,
     "Tolerance at which to start crossover", advanced=True)
_opt("dual_simplex_cost_perturbation_multiplier", float, 1.0,
     "Dual simplex cost perturbation multiplier", 0.0, advanced=True)
_opt("primal_simplex_bound_perturbation_multiplier", float, 1.0,
     "Primal simplex bound perturbation multiplier", 0.0, advanced=True)
_opt("cost_scale_factor", int, 0, "Exponent of power-of-two cost scale",
     advanced=True)

# --- iCrash ----------------------------------------------------------------
_opt("icrash", bool, False, "Run iCrash", advanced=True)
_opt("icrash_dualize", bool, False, "Dualize strategy for iCrash",
     advanced=True)
_opt("icrash_strategy", str, "ICA", "iCrash strategy", advanced=True)
_opt("icrash_starting_weight", float, 1e-10, "iCrash starting weight",
     1e-10, 1e50, advanced=True)
_opt("icrash_iterations", int, 30, "iCrash iterations", 0, 200, advanced=True)
_opt("icrash_approx_iter", int, 50, "iCrash approximate solve iterations",
     0, 100, advanced=True)
_opt("icrash_exact", bool, False, "Exact subproblem solves in iCrash",
     advanced=True)
_opt("icrash_breakpoints", bool, False, "Exact breakpoint strategy",
     advanced=True)

# --- MIP -------------------------------------------------------------------
_opt("mip_detect_symmetry", bool, True, "Detect symmetry in MIP")
_opt("mip_allow_restart", bool, True, "Allow MIP restart")
_opt("mip_max_nodes", int, kHighsIInf, "MIP node limit", 0)
_opt("mip_max_stall_nodes", int, kHighsIInf,
     "MIP stall node limit (no improvement)", 0)
_opt("mip_max_start_nodes", int, 500,
     "Node limit for sub-MIP heuristics", 0)
_opt("mip_max_leaves", int, kHighsIInf, "MIP leaf node limit", 0)
_opt("mip_max_improving_sols", int, kHighsIInf,
     "Limit on improving solutions found", 1)
_opt("mip_lp_age_limit", int, 10, "Age limit for LP rows in MIP", 0)
_opt("mip_pool_age_limit", int, 30, "Age limit for cut-pool rows", 0)
_opt("mip_pool_soft_limit", int, 10000, "Soft cut-pool size limit", 1)
_opt("mip_pscost_minreliable", int, 8,
     "Minimal pseudocost reliability", 0)
_opt("mip_min_cliquetable_entries_for_parallelism", int, 100000,
     "Clique table size before parallel queries", 0)
_opt("mip_report_level", int, 1, "MIP report level", 0, 2)
_opt("mip_feasibility_tolerance", float, 1e-6, "MIP feasibility tolerance",
     1e-10)
_opt("mip_rel_gap", float, 1e-4, "MIP relative gap tolerance", 0.0)
_opt("mip_abs_gap", float, 1e-6, "MIP absolute gap tolerance", 0.0)
_opt("mip_heuristic_effort", float, 0.05, "Effort spent on MIP heuristics",
     0.0, 1.0)
_opt("mip_heuristic_run_feasibility_jump", bool, True,
     "Run feasibility-jump heuristic")
_opt("mip_heuristic_run_rins", bool, True, "Run RINS heuristic")
_opt("mip_parallel_heuristics", bool, True,
     "Run a feasibility-jump heuristic worker on a host thread "
     "concurrently with the native tree search, with incumbent "
     "objectives shared into the engine for pruning (reference "
     "parallel MIP workers role)", advanced=True)
_opt("mip_heuristic_run_rens", bool, True, "Run RENS heuristic")
_opt("mip_heuristic_run_root_reduced_cost", bool, True,
     "Run root-reduced-cost heuristic")
_opt("mip_heuristic_run_zi_round", bool, False, "Run ZI-round heuristic")
_opt("mip_heuristic_run_shifting", bool, False, "Run shifting heuristic")
_opt("mip_min_logging_interval", float, 5.0, "Minimal MIP logging interval")
_opt("mip_lp_solver", str, "choose", "LP solver for MIP relaxations")
_opt("mip_ipm_solver", str, "choose", "IPM solver used inside MIP")
_opt("mip_debug_solution_file", str, "", "Debug solution file", advanced=True)
_opt("mip_improving_solution_save", bool, False,
     "Save improving solutions")
_opt("mip_improving_solution_report_sparse", bool, False,
     "Report improving solutions sparsely")
_opt("mip_improving_solution_file", str, "",
     "File for improving solutions")
_opt("mip_root_presolve_only", bool, False, "Only presolve at MIP root",
     advanced=True)
_opt("mip_lifting_for_probing", int, -1, "Lifting for probing", -1, 2,
     advanced=True)
_opt("mip_search_simulate_concurrency", bool, False,
     "Deterministically simulate concurrent MIP search", advanced=True)
_opt("mip_allow_cut_separation_at_nodes", bool, True,
     "Allow cut separation at nodes")

# --- advanced simplex/presolve tuning (reference HighsOptions.h advanced
# records; accepted for option-file compatibility, honored where the
# corresponding machinery exists) -------------------------------------------
_opt("allow_pdlp_cleanup", bool, True,
     "Allow PDLP to clean up model with unknown status and no basis",
     advanced=True)
_opt("allowed_cost_scale_factor", int, 0,
     "Largest power-of-two factor permitted when scaling the costs",
     0, 20, advanced=True)
_opt("allowed_matrix_scale_factor", int, 20,
     "Largest power-of-two factor permitted when scaling the matrix",
     0, 30, advanced=True)
_opt("dual_simplex_pivot_growth_tolerance", float, 1e-9,
     "Dual simplex pivot growth tolerance", 1e-12, kHighsInf,
     advanced=True)
_opt("dual_steepest_edge_weight_error_tolerance", float, kHighsInf,
     "Tolerance on dual steepest edge weight errors", 0.0, kHighsInf,
     advanced=True)
_opt("dual_steepest_edge_weight_log_error_threshold", float, 1e1,
     "Threshold on DSE weight errors for Devex switch", 1.0, kHighsInf,
     advanced=True)
_opt("lp_presolve_requires_basis_postsolve", bool, True,
     "Prevents LP presolve steps for which postsolve cannot maintain a "
     "basis", advanced=True)
_opt("max_dual_simplex_cleanup_level", int, 1,
     "Max level of dual simplex cleanup", 0, kHighsIInf, advanced=True)
_opt("max_dual_simplex_phase1_cleanup_level", int, 2,
     "Max level of dual simplex phase 1 cleanup", 0, kHighsIInf,
     advanced=True)
_opt("no_unnecessary_rebuild_refactor", bool, True,
     "No unnecessary refactorization on simplex rebuild", advanced=True)
_opt("presolve_pivot_threshold", float, 0.01,
     "Matrix factorization pivot threshold for presolve substitutions",
     8e-3, 0.5, advanced=True)
_opt("presolve_rule_test", int, 0, "Presolve rule to test - DEV only!",
     0, 1 << 16, advanced=True)
_opt("rebuild_refactor_solution_error_tolerance", float, 1e-8,
     "Tolerance on solution error for refactorization on rebuild",
     -kHighsInf, kHighsInf, advanced=True)
_opt("simplex_unscaled_solution_strategy", int, 1,
     "Strategy for solving unscaled LP in simplex", 0, 2, advanced=True)
_opt("write_hessian_image", bool, False,
     "Write an image of the Hessian to a file", advanced=True)
_opt("write_matrix_image", bool, False,
     "Write an image of the constraint matrix to a file", advanced=True)

# --- Device options (named tpu_* for parity with the JAX package) ----------
_opt("tpu_dtype", str, "choose",
     "Compute dtype on device: float32 / float64 / choose.  'choose' "
     "resolves to float64 on CPU and float32 on CUDA; f32 solves are "
     "driven to f64-grade KKT by shifted-iterate refinement in the PDLP "
     "wrapper")
_opt("tpu_matrix_format", str, "choose",
     "Device matrix format: dense / bcoo / blockcsr / onehot / ell / panelell / bucketell / choose")
_opt("tpu_check_interval", int, 40,
     "Device-resident PDHG steps per convergence check "
     "(the jitted inner block length)", 1)
_opt("tpu_pdlp_device_restarts", bool, True,
     "Run the Halpern restart criteria on device at 40-step windows "
     "inside the fused block (reference cadence); off = per-block "
     "host restart logic")
_opt("tpu_mesh_shape", str, "",
     "Device mesh, e.g. '4x2'; empty = single device")
_opt("tpu_batch_solve", bool, False,
     "Batch multiple instances through vmapped solves")
_opt("tpu_ipm_newton", str, "choose",
     "IPM normal-equations solver: choose / cholesky / cg / ldl / "
     "dense_m (cg = matrix-free Jacobi-preconditioned conjugate "
     "gradients; ldl = normal matrix factored sparse on the host; "
     "dense_m = normal matrix assembled sparse, factored dense on the "
     "solver's device)")
_opt("tpu_mip_native_search", bool, True,
     "Run the MIP tree search in the native C++ dive loop "
     "(hx_mip_solve): ~100x node throughput of the Python loop, with "
     "reliability strong branching, in-search rounding completion and "
     "exact incumbent revalidation; falls back to the Python loop on "
     "numerical rejection or unsupported features")
_opt("tpu_mip_batch_nodes", int, 0,
     "Evaluate MIP node LPs in vmapped device batches of this size "
     "(0 = sequential node engine)", 0, 1024)
_opt("tpu_step_dtype", str, "",
     "Mixed-precision PDHG stepping: '' = full precision, 'bfloat16' "
     "= bf16 step matvecs until residuals reach 1e-3")
_opt("pdlp_checkpoint_file", str, "",
     "Checkpoint/resume file for long PDHG runs (empty = off)")
_opt("pdlp_checkpoint_interval", int, 50,
     "Checkpoint every N convergence-check blocks", 1)

_BY_NAME: Dict[str, OptionRecord] = {r.name: r for r in _REGISTRY}

# Tolerance options that follow kkt_tolerance when it is changed
# (reference behavior: docs/src/guide/gpu.md:30-37 & Highs::setOptionValue)
_KKT_CASCADE = (
    "primal_feasibility_tolerance",
    "dual_feasibility_tolerance",
    "primal_residual_tolerance",
    "dual_residual_tolerance",
    "optimality_tolerance",
    "pdlp_optimality_tolerance",
)


class HighsOptions:
    """Mutable option container with attribute and by-name access."""

    def __init__(self):
        object.__setattr__(self, "_values", {r.name: r.default
                                             for r in _REGISTRY})

    def __copy__(self):
        new = HighsOptions.__new__(HighsOptions)
        object.__setattr__(new, "_values",
                           dict(object.__getattribute__(self, "_values")))
        for k, v in self.__dict__.items():
            if k != "_values":
                object.__setattr__(new, k, v)
        return new

    def copy(self):
        import copy as _copy
        return _copy.copy(self)

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name):
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            # internal (non-registry) attributes, e.g. sub-MIP depth
            object.__setattr__(self, name, value)
            return
        status, _ = self.set(name, value)
        if status != HighsStatus.kOk:
            raise ValueError(f"invalid value {value!r} for option {name!r}")

    # -- registry access ----------------------------------------------------
    @staticmethod
    def records() -> List[OptionRecord]:
        return list(_REGISTRY)

    @staticmethod
    def record(name: str) -> Optional[OptionRecord]:
        return _BY_NAME.get(name)

    def set(self, name: str, value: Any):
        rec = _BY_NAME.get(name)
        if rec is None:
            return HighsStatus.kError, None
        status, coerced = rec.validate(value)
        if status != HighsStatus.kOk:
            return status, None
        self._values[name] = coerced
        if name == "kkt_tolerance":
            # kkt_tolerance cascades into the individual tolerances
            for cascade_name in _KKT_CASCADE:
                self._values[cascade_name] = coerced
        return HighsStatus.kOk, coerced

    def get(self, name: str):
        rec = _BY_NAME.get(name)
        if rec is None:
            return HighsStatus.kError, None
        return HighsStatus.kOk, self._values[name]

    def reset(self):
        self._values.update({r.name: r.default for r in _REGISTRY})

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    def non_default(self) -> Dict[str, Any]:
        return {n: v for n, v in self._values.items()
                if v != _BY_NAME[n].default
                and not (isinstance(v, float) and isinstance(_BY_NAME[n].default, float)
                         and math.isnan(v) and math.isnan(_BY_NAME[n].default))}

    # -- options file -------------------------------------------------------
    def read_options_file(self, path: str) -> HighsStatus:
        """Read a HiGHS-style options file: `name = value` lines, # comments."""
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            return HighsStatus.kError
        status = HighsStatus.kOk
        for line in lines:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                status = HighsStatus.kWarning
                continue
            name, _, value = line.partition("=")
            name, value = name.strip(), value.strip().strip('"')
            st, _ = self.set(name, value)
            if st != HighsStatus.kOk:
                status = HighsStatus.kWarning
        return status

    def write_options_file(self, path: str, report_only_deviations=False):
        with open(path, "w") as f:
            for rec in _REGISTRY:
                value = self._values[rec.name]
                if report_only_deviations and value == rec.default:
                    continue
                if rec.type is bool:
                    value = "true" if value else "false"
                f.write(f"{rec.name} = {value}\n")
