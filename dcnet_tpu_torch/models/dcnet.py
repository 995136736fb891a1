"""DCNet grounding model, eval path (PyTorch).

The port of the inference half of `dcnet_tpu/models/dcnet.py`: backbone +
per-scale mapping (`extract_features`), the language encoder
(`encode_language`), the correspondence stage (`corr_features`: the center
frame co-attends to each reference through kernel K1, then the split
corr_conv, l2-norm and the mean over references), the fusion trunk with
subject/location attention and confidence modulation (`_trunk`), and
`eval_features` / `eval_clip`. The module tree carries the reference
state_dict names, so the reference `.pth.tar` state_dict (and
`weights.state_dict_from_jax` of a JAX checkpoint) loads with strict=True.

Public layouts follow the JAX package: images NHWC (B*n, H, W, 3), per-frame
features (B, n, h, w, C), outbox (B, 3, 5, g, g). The training forward, the
single-image baseline, the serving ring (`newest_slot`) and the opt-in
co-attention variants are later slices (ROADMAP queues A and B).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from dcnet_tpu_torch import DeviceLike, resolve_device, resolve_dtype
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.kernels.coattn import coattention_center_fused
from dcnet_tpu_torch.models.attention import PhraseAttention
from dcnet_tpu_torch.models.darknet import (
    DarknetBackbone, LayerDef, yolov3_layer_defs)
from dcnet_tpu_torch.models.heads import (
    ConvBNReLU, DenseBNReLU, MappingLang, build_fusion_fcn, fusion_fcn,
    l2_normalize, tile_language)
from dcnet_tpu_torch.models.lstm import BiLSTMEncoder
from dcnet_tpu_torch.ops.coords import generate_coord


class EvalOutputs(NamedTuple):
    outbox: List[torch.Tensor]      # per scale (B, 3, 5, g, g) center frame
    sim_score: List[torch.Tensor]   # per scale (B, g, g)
    loc_score: List[torch.Tensor]   # per scale (B, g, g)
    corr_feat: List[torch.Tensor]   # per scale (B, g, g, C)
    only_obj: List[torch.Tensor]    # per scale (B, g, g) raw objectness


def _not_ported(option: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to dcnet_tpu_torch yet ({where})")


class DCNet(nn.Module):
    """The eval model. Parameters stay fp32; activations are stored in
    cfg.compute_dtype, BN math runs in fp32. `device` defaults to the CUDA
    card (`default_device()`)."""

    def __init__(self, cfg: DCNetConfig,
                 backbone_defs: Optional[Sequence[LayerDef]] = None,
                 device: DeviceLike = None):
        super().__init__()
        if not cfg.use_lstm:
            raise _not_ported("the BERT text encoder", "ROADMAP queue A, item 10")
        if cfg.trunk_quant != "off" or cfg.coattn_int8_logits:
            raise _not_ported("int8 trunk / co-attention logits",
                              "ROADMAP queue A, item 9")
        if cfg.coattn_batch_refs:
            raise _not_ported("coattn_batch_refs", "ROADMAP queue A, item 9")
        if cfg.coattn_multiref:
            raise _not_ported("coattn_multiref (ring kernel K4)",
                              "ROADMAP queue B, K4")
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.compute_dtype)
        dt, emb, textdim = self.dtype, cfg.emb_size, cfg.textdim
        defs = tuple(backbone_defs) if backbone_defs is not None \
            else yolov3_layer_defs()
        captured = [ld.in_filters for ld in defs if ld.type == "yoloconvolutional"]

        self.visumodel = DarknetBackbone(defs, device=device)
        self.textmodel = BiLSTMEncoder(
            cfg.corpus_size, cfg.word_embedding_size, textdim // 2,
            textdim // 2, cfg.input_dropout, dtype=dt, device=device)
        self.sub_attn = PhraseAttention(textdim, dtype=dt, device=device)
        self.loc_attn = PhraseAttention(textdim, dtype=dt, device=device)
        self.loc_embedding = DenseBNReLU(8, 8, dtype=dt, device=device)
        self.loc_text_embedding = DenseBNReLU(
            cfg.all_positions, emb, dtype=dt, device=device)
        self.mapping_visu = nn.ModuleList(
            ConvBNReLU(c, emb, 1, dtype=dt, device=device) for c in captured)
        self.mapping_lang = MappingLang(textdim, emb, cfg.jemb_dropout,
                                        dtype=dt, device=device)
        self.corr_conv = nn.ModuleList(
            nn.Sequential(ConvBNReLU(2 * emb, emb, 1, dtype=dt, device=device))
            for _ in range(3))
        # Conv1d word-patch smoothing: used by the training forward only,
        # kept so the reference state_dict loads strictly
        self.feature_map = nn.Sequential(nn.Conv1d(
            cfg.query_len, cfg.query_len, 3, padding=1, device=device))
        fcns = [build_fusion_fcn(2 * emb + 8, emb, cfg.light, dtype=dt,
                                 device=device) for _ in range(3)]
        self.fcn_emb = nn.ModuleList(f[0] for f in fcns)
        self.fcn_out = nn.ModuleList(f[1] for f in fcns)
        self.to(memory_format=torch.channels_last)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.feature_map[0].weight.device

    # ------------------------------------------------------------------
    # shared pieces
    # ------------------------------------------------------------------

    def map_features(self, raw: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per-scale mapping + channel l2-norm over raw backbone maps."""
        return [l2_normalize(self.mapping_visu[i](raw[i])) for i in range(3)]

    @torch.no_grad()
    def extract_features(self, images) -> List[torch.Tensor]:
        """Backbone + mapping: NHWC images (N, H, W, 3) -> per scale
        (N, g, g, C) mapped, l2-normalised features."""
        images = torch.as_tensor(images, device=self.device)
        return self.map_features(self.visumodel(images, self.dtype))

    def _language(self, word_ids: torch.Tensor):
        raw_flang, context, embedded = self.textmodel(word_ids)
        return l2_normalize(self.mapping_lang(raw_flang)), context, embedded

    @torch.no_grad()
    def encode_language(self, word_ids):
        """(flang (B, C) mapped + normalised, context, embedded)."""
        return self._language(torch.as_tensor(word_ids, device=self.device))

    @torch.no_grad()
    def corr_features(self, per_frame: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
        """Center-vs-each-reference co-attention (K1) + corr_conv,
        l2-normalised and averaged over the references.
        per_frame: per scale (B, n_frame, h, w, C)."""
        cfg = self.cfg
        n_frame = per_frame[0].shape[1]
        center = n_frame // 2
        ref_idx = [j for j in range(n_frame) if j != center]
        corr_feat = []
        for i in range(3):
            frames = per_frame[i]
            cen = frames[:, center]
            atts = [coattention_center_fused(cen, frames[:, j],
                                             cfg.coattn_temperature)
                    for j in ref_idx]
            conv = self.corr_conv[i][0]
            if cfg.split_corr_conv:  # center half of the 1x1 contraction once
                cfs = conv((cen, atts))
            else:
                cfs = [conv(torch.cat([cen, a], dim=-1)) for a in atts]
            acc = None
            for cf in cfs:
                cf = l2_normalize(cf)
                acc = cf if acc is None else acc + cf
            corr_feat.append(acc / len(ref_idx))
        return corr_feat

    def _trunk(self, corr_feat: Sequence[torch.Tensor], flang: torch.Tensor,
               context: torch.Tensor, embedded: torch.Tensor,
               word_ids: torch.Tensor):
        """Fusion FCN + subject/location attention + conf modulation."""
        cfg = self.cfg
        b = corr_feat[0].shape[0]
        coord_list = [
            generate_coord(f.shape[1], f.shape[2], device=f.device)
            .permute(1, 2, 0)[None].expand(b, f.shape[1], f.shape[2], 8)
            for f in corr_feat]

        outbox = []
        for i, f in enumerate(corr_feat):
            fused_in = torch.cat(
                [f, tile_language(flang, f.shape[1], f.shape[2]).to(f.dtype),
                 coord_list[i].to(f.dtype)], dim=-1)
            _, ob = fusion_fcn(self.fcn_emb[i], self.fcn_out[i], fused_in,
                               self.dtype)
            outbox.append(ob)

        # subject attention -> similarity score per position
        _, flang_attn = self.sub_attn(context, embedded, word_ids)
        flang_attn = l2_normalize(flang_attn)
        sim_score = [torch.einsum("bc,bhwc->bhw", flang_attn, f.to(flang_attn.dtype))
                     for f in corr_feat]
        only_obj = [ob[:, :, 4].mean(dim=1) for ob in outbox]
        obj_score = [oo * ss for oo, ss in zip(only_obj, sim_score)]

        # location attention over the rank-8 coordinate Gram factors
        _, flang_loc = self.loc_attn(context, embedded, word_ids)
        flang_loc = l2_normalize(flang_loc)
        coord_map = torch.cat([c.reshape(b, -1, 8) for c in coord_list], dim=1)
        obj_map = l2_normalize(
            torch.cat([o.reshape(b, -1) for o in obj_score], dim=1))
        coord_emb = self.loc_embedding(coord_map.reshape(-1, 8))
        coord_emb = l2_normalize(coord_emb.reshape(b, -1, 8), dim=2)
        rel = self.loc_text_embedding(None, gram_factors=(coord_emb, obj_map))
        rel = l2_normalize(rel.reshape(b, cfg.all_positions, -1), dim=2)
        loc_map = torch.einsum("bpc,bc->bp", rel, flang_loc.to(rel.dtype))
        lo = loc_map.min(dim=1, keepdim=True).values
        hi = loc_map.max(dim=1, keepdim=True).values
        loc_map = (loc_map - lo) / (hi - lo + 1e-6)

        loc_score, s = [], 0
        for f in corr_feat:
            g2 = f.shape[1] * f.shape[2]
            loc_score.append(loc_map[:, s:s + g2].reshape(b, f.shape[1], f.shape[2]))
            s += g2

        # confidence modulation: conf *= sim * loc
        modulated = []
        for ob, ss, ls in zip(outbox, sim_score, loc_score):
            ob = ob.clone()
            ob[:, :, 4] = (ob[:, :, 4] * (ss * ls)[:, None]).to(ob.dtype)
            modulated.append(ob)
        return modulated, sim_score, loc_score, only_obj, flang_attn

    # ------------------------------------------------------------------
    # inference forward: n-frame clip, center-frame prediction
    # ------------------------------------------------------------------

    @torch.no_grad()
    def eval_features(self, per_frame: Sequence[torch.Tensor], word_ids,
                      language: Optional[Tuple[torch.Tensor, ...]] = None
                      ) -> EvalOutputs:
        """Trunk over pre-extracted per-frame features (per scale
        (B, n_frame, h, w, C)); word_ids (B, L). Pass `language` =
        (flang, context, embedded) to skip the text encoder."""
        word_ids = torch.as_tensor(word_ids, device=self.device)
        corr_feat = self.corr_features(per_frame)
        if language is None:
            language = self._language(word_ids)
        flang, context, embedded = language
        outbox, sim_score, loc_score, only_obj, _ = self._trunk(
            corr_feat, flang, context, embedded, word_ids)
        return EvalOutputs(outbox=outbox, sim_score=sim_score,
                           loc_score=loc_score, corr_feat=corr_feat,
                           only_obj=only_obj)

    @torch.no_grad()
    def eval_clip(self, images, word_ids, n_frame: int = 5) -> EvalOutputs:
        """images: NHWC (B*n_frame, H, W, 3), clips frame-contiguous;
        word_ids: (B, L), the center frame's phrase. Predictions for the
        center frame of each clip."""
        fvisu = self.extract_features(images)
        b = fvisu[0].shape[0] // n_frame
        per_frame = [f.reshape(b, n_frame, *f.shape[1:]) for f in fvisu]
        return self.eval_features(per_frame, word_ids)
