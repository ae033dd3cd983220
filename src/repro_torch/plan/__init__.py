"""``repro_torch.plan`` — end-to-end heterogeneous plan autotuner (DESIGN.md §9).

One call replaces the hand-set flag soup (collective mode, channel count,
bucket size, ZeRO stage, per-pod micro-batch shares):

    from repro_torch import plan
    req = plan.plan_request(cluster, model_cfg, global_batch=256,
                            seq_len=4096, data_axis=8)
    tp  = plan.autotune(req)        # best TrainPlan, priced by the simulator
    rc  = tp.run_config()           # -> RunConfig for make_train_program

See ``autotuner`` for the search, ``refine`` for the measured-profile
feedback loop, ``measured`` for the bench-record calibration (DESIGN.md
§14), and DESIGN.md §9 for the cost model and re-plan contract.
Counterpart of ``repro/plan``, the port's own copy, exporting the same
names.
"""
from repro_torch.plan.autotuner import (CLASS_REP_BYTES, DEFAULT_BUCKET,
                                  DEFAULT_SPACE, MiB, POLICY_OPS,
                                  RING_BACKED_OPS, PlanRequest,
                                  SearchSpace, TrainPlan, autotune,
                                  autotune_policies, best_policy,
                                  estimate_hbm_bytes, grad_payload_bytes,
                                  plan_request,
                                  pod_profiles, policy_table_for, rank,
                                  workload_for)
from repro_torch.plan.measured import (AlphaBetaFit, CalibrationRow, bench_cluster,
                                 calibrated_plan, calibration_record,
                                 calibration_report, comm_scale_from_report,
                                 fit_alpha_beta, flight_cells,
                                 missing_table_rows,
                                 modeled_train_step_s, planner_check,
                                 profiles_from_train, rows_from_flight,
                                 train_request)
from repro_torch.plan.refine import calibrate, refine, refined_frontier

__all__ = [
    "AlphaBetaFit", "CLASS_REP_BYTES", "CalibrationRow", "DEFAULT_BUCKET",
    "DEFAULT_SPACE", "MiB",
    "POLICY_OPS", "RING_BACKED_OPS", "PlanRequest", "SearchSpace", "TrainPlan", "autotune",
    "autotune_policies", "bench_cluster", "best_policy", "calibrate",
    "calibrated_plan", "calibration_record", "calibration_report",
    "comm_scale_from_report", "estimate_hbm_bytes", "fit_alpha_beta",
    "flight_cells", "grad_payload_bytes", "missing_table_rows",
    "modeled_train_step_s",
    "plan_request", "planner_check", "pod_profiles", "policy_table_for",
    "profiles_from_train", "rank", "refine", "rows_from_flight",
    "refined_frontier", "train_request", "workload_for",
]
