from dcnet_tpu_torch.utils.profiling import (  # noqa: F401
    COUNTERS, SPANS, device_trace, record_spans, stage_ms, summarize_trace, trace_annotation)
