"""The system under test, `dcnet_tpu_torch`, as the benchmark builds it:
its DCNet configuration from the benchmark's configuration file and the
cell's traffic, its model on the device with the benchmark's weights. The
program is imported here, inside functions, and nowhere at module level.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.geometry import Geometry


def program_config(g: Geometry, traffic: dict):
    """The program's DCNetConfig for this geometry and traffic (its
    `program` group: compute dtype and the path's switches)."""
    from dcnet_tpu_torch.config import DCNetConfig

    opts = traffic.get("program", {})
    bert_model = "bert-base-uncased"
    if g.text_encoder == "bert" and g.bert.hidden_size != 768:
        bert_model = "bert-mini"     # the CPU tests' small geometry
    return DCNetConfig(
        dataset="VID", image_size=g.image_size, anchor_imsize=g.anchor_imsize,
        emb_size=g.emb_size, query_len=g.query_len, n_frames_train=g.n_frames_train,
        n_frames_test=g.n_frames_test, use_lstm=g.text_encoder == "bilstm",
        bert_model=bert_model, corpus_size=g.corpus_size, lstm_hidden=g.lstm_hidden,
        word_embedding_size=g.word_embedding_size, coattn_temperature=g.coattn_temperature,
        lr=g.lr, backbone_lr_scale=g.backbone_lr_scale, weight_decay=g.weight_decay,
        optimizer="rmsprop",
        compute_dtype=opts.get("compute_dtype", "float32"),
        split_corr_conv=bool(opts.get("split_corr_conv", True)),
        coattn_multiref=bool(opts.get("coattn_multiref", False)))


def build_model(g: Geometry, traffic: dict, weights: Dict[str, torch.Tensor], device):
    """The program's DCNet on `device`, loaded strictly with `weights`."""
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs, yolov3_layer_defs
    from dcnet_tpu_torch.models.dcnet import DCNet

    defs = yolov3_layer_defs() if g.backbone == "yolov3" else mini_backbone_defs()
    model = DCNet(program_config(g, traffic), backbone_defs=defs, device=device)
    model.load_state_dict(weights, strict=True)
    return model
