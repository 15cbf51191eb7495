"""Attribution of `torch.profiler` traces (JAX `profiling/`).

The trainer's ``CSDT_PROFILE_DIR`` window, `profile_sampler.py` and
`profile_train_step.py` write Chrome traces; `trace.attribute` splits their
device time by kernel family.

CLI: ``python -m conditional_score_diffusion_tpu_torch.profiling <trace>``.
"""

from .trace import (  # noqa: F401
    attribute,
    attribute_profile,
    classify,
    device_ms,
    device_op_table,
    find_trace_files,
    kernel_launches,
    parse_trace,
    per_unit_lines,
)
