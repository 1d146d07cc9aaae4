"""Cori core, PyTorch port of ``repro/core``: reuse collection (``reuse``),
frequency generation + tuning (``cori``), the trace-driven hybrid-memory
simulator (``sim``, on the ``page_hist`` and ``sim_scan`` kernels),
application trace generators (``traces``), prior-work baselines
(``baselines``), the end-to-end pipeline (``pipeline``) and the serving
traffic streams the model-free ``serve.sched.TrafficScheduler`` replays
(``traffic``: Poisson arrivals, mix shifts and the hostile shapes)."""
from repro_torch.core.baselines import (BASELINE_ORDERS, TABLE_I_PERIODS,
                                        base_candidates, ordered_candidates,
                                        table_i_periods_for)
from repro_torch.core.cori import (OnlineTuner, Tuner, TuneResult,
                                   candidate_periods, dominant_reuse,
                                   trials_to_best)
from repro_torch.core.pipeline import (AppStudy, CoriRun, baseline_trials,
                                       baseline_trials_all, optimal_runtime,
                                       run_cori, study, table_i_runtimes)
from repro_torch.core.reuse import (ReuseHistogram, StreamingReuseCollector,
                                    loop_duration_histogram,
                                    prune_insignificant,
                                    reuse_distance_histogram, reuse_distances)
from repro_torch.core.sim import (SCHEDULERS, SimConfig, SimResult, TraceBins,
                                  bin_trace, exhaustive_periods, simulate,
                                  simulate_reference, sweep, sweep_loop)
from repro_torch.core.traces import (TRACE_GENERATORS, Trace,
                                     available_traces, generate)
from repro_torch.core.traffic import (RequestSpec, correlated_burst_stream,
                                      diurnal_stream, flash_crowd_stream,
                                      invert_kinds, mix_inversion_stream,
                                      modulated_request_stream,
                                      poisson_request_stream,
                                      shifting_mix_stream)

__all__ = [
    "AppStudy", "BASELINE_ORDERS", "CoriRun", "OnlineTuner", "RequestSpec",
    "ReuseHistogram",
    "SCHEDULERS", "SimConfig", "SimResult", "StreamingReuseCollector",
    "TRACE_GENERATORS", "Trace", "TraceBins", "Tuner", "TuneResult",
    "available_traces", "base_candidates", "baseline_trials",
    "baseline_trials_all", "bin_trace", "candidate_periods",
    "correlated_burst_stream", "diurnal_stream", "dominant_reuse",
    "flash_crowd_stream", "invert_kinds", "mix_inversion_stream",
    "modulated_request_stream", "poisson_request_stream",
    "shifting_mix_stream", "exhaustive_periods", "generate",
    "loop_duration_histogram", "optimal_runtime", "ordered_candidates",
    "prune_insignificant", "reuse_distance_histogram", "reuse_distances",
    "run_cori", "simulate", "simulate_reference", "study", "sweep",
    "sweep_loop", "table_i_periods_for", "table_i_runtimes",
    "trials_to_best", "TABLE_I_PERIODS",
]
