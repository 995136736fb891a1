from dcnet_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer, annotate, device_trace, summarize_trace, trace_annotation)
