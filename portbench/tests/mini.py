"""Small sizes for the CPU tests: the five-layer stand-in backbone at 64 px,
widths of 16 (BERT: the 128-wide, 4-layer geometry), a few streams or
clips. The cells' traffic files, loops and limits are the real ones."""

from __future__ import annotations

from portbench import harness

GEOMETRY = {"backbone": "mini", "image_size": 64, "emb_size": 16, "lstm_hidden": 16,
            "word_embedding_size": 16, "corpus_size": 50}
BERT = {"bert": {"vocab_size": 30522, "hidden_size": 128, "num_layers": 4, "num_heads": 4,
                 "intermediate_size": 512, "max_position": 512, "type_vocab_size": 2,
                 "layer_norm_eps": 1e-12}}
TRAFFIC = {"streams": 3, "clips": 2, "pool_ticks": 8, "check_ticks": 1, "check_calls": 1,
           "check_block": 2, "check_window_steps": 1, "trace_units": 2,
           "calibration_frames": 6}
SEED = 2 ** 33 + 7


def traffic_name(workload: str) -> str:
    return next(w["traffic"] for w in harness.manifest()["workloads"] if w["name"] == workload)


def geometry(workload: str) -> dict:
    return dict(GEOMETRY, **(BERT if "bert" in workload else {}))


def run(workload: str, seed: int = SEED, seconds: float = 0.0, trace: bool = False,
        traffic=None, **kw) -> dict:
    """One run of the cell on the CPU at the small sizes; a window of
    `seconds` 0 times one unit, so the samples compared do not depend on
    the machine's speed."""
    return harness.run_cell(workload, seed, seconds, trace, device="cpu",
                            geometry_overrides=geometry(workload),
                            traffic_overrides=dict(TRAFFIC, **(traffic or {})), **kw)
