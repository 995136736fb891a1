"""DCNet grounding model (PyTorch): the training forward and the eval path.

The port of `dcnet_tpu/models/dcnet.py`: backbone + per-scale mapping
(`extract_features`), the language encoder (`encode_language`), the
correspondence stage (`corr_features`: the center frame co-attends to each
reference through kernel K1, then the split corr_conv, l2-norm and the mean
over references), the fusion trunk with subject/location attention and
confidence modulation (`_trunk`), `eval_features` / `eval_clip`, and the
training forward `forward(images, word_ids, train=True)` on interleaved
k-frame clips: k=2 pairs the frames through kernel K2 (both directions,
gradient 2 x K3), k>2 ring-pairs frame j with frame j+1 through K1 (gradient
K3), then the trunk and the inter-frame and cross-modal contrastive samples.
The module tree carries the reference state_dict names, so the reference
`.pth.tar` state_dict (and `weights.state_dict_from_jax` of a JAX
checkpoint) loads with strict=True.

Public layouts follow the JAX package: images NHWC (B*n, H, W, 3), per-frame
features (B, n, h, w, C), outbox (B, 3, 5, g, g). The correspondence stage
also reads the serving engine's rotating feature rings (`newest_slot`, int8
rings dequantised on read) and, with `cfg.coattn_multiref`, co-attends the
center to every reference in one launch of kernel K4 per scale.
`single_image` is the correspondence-free baseline: the trunk on the mapped
features of single images, no co-attention. The eval path's opt-in variants
follow the JAX package: `cfg.coattn_batch_refs` attends to every reference
in one batched einsum and keeps them stacked through the split corr_conv,
`cfg.coattn_int8_logits` takes the co-attention logits from int8 codes
(both torch products, no kernel, as in JAX), and `cfg.trunk_quant` sets the
int8 mode of mapping_visu, corr_conv and the fusion FCNs' ConvBNReLUs
(static-scale PTQ through kernel K6; `ops/quant.py` calibrates it).
The language encoder is the BiLSTM (`cfg.use_lstm`) or the frozen BERT
(`models/bert.py`, sized by `cfg.bert_model`); on the BERT path the
cross-modal branch reads BERT's projected `embedded` where the BiLSTM's
halved context goes. `cfg.remat_backbone` recomputes the backbone in the
backward (`torch.utils.checkpoint`), its BatchNorm statistics moved once.
`cfg.tp_internals` on a mesh with a model axis (`parallel.mesh`) splits the
co-attention's query rows over the model group (`ops.coattention`'s
`tp_shard`: K1 / K2 / K3 on row windows) in the train forward and the
per-reference eval path, float and int8 logits, as the JAX package
annotates them; the ring (K4) and batched-references paths stay whole, as
there.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dcnet_tpu_torch import DeviceLike, resolve_device, resolve_dtype
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.kernels.coattn import (
    coattention_center_fused, coattention_pair_fused, coattention_ring_fused,
    ring_slots)
from dcnet_tpu_torch.models.attention import PhraseAttention
from dcnet_tpu_torch.models.bert import BertEncoder
from dcnet_tpu_torch.models.darknet import (
    DarknetBackbone, LayerDef, yolov3_layer_defs)
from dcnet_tpu_torch.models.heads import (
    ConvBNReLU, DenseBNReLU, MappingLang, build_fusion_fcn, fusion_fcn,
    l2_normalize, running_stats_frozen, tile_language)
from dcnet_tpu_torch.models.lstm import BiLSTMEncoder
from dcnet_tpu_torch.ops.coattention import (
    coattention_center, coattention_center_batched, coattention_pair)
from dcnet_tpu_torch.ops.coords import generate_coord
from dcnet_tpu_torch.ops.correspondence import (
    ContrastiveSamples, crossmodal_pairs, interframe_pairs)
from dcnet_tpu_torch.parallel import mesh
from dcnet_tpu_torch.utils.profiling import on_device, trace_annotation


class TrainOutputs(NamedTuple):
    outbox: List[torch.Tensor]      # per scale (kB, 3, 5, g, g)
    sim_score: List[torch.Tensor]   # per scale (kB, g, g)
    loc_score: List[torch.Tensor]   # per scale (kB, g, g)
    corr_feat: List[torch.Tensor]   # per scale (kB, g, g, C) fused features
    flang_attn: torch.Tensor        # (kB, C) subject-attended phrase
    interframe: ContrastiveSamples
    crossmodal: ContrastiveSamples
    only_obj: List[torch.Tensor]    # per scale (kB, g, g) raw objectness


class EvalOutputs(NamedTuple):
    outbox: List[torch.Tensor]      # per scale (B, 3, 5, g, g) center frame
    sim_score: List[torch.Tensor]   # per scale (B, g, g)
    loc_score: List[torch.Tensor]   # per scale (B, g, g)
    corr_feat: List[torch.Tensor]   # per scale (B, g, g, C)
    only_obj: List[torch.Tensor]    # per scale (B, g, g) raw objectness


class DCNet(nn.Module):
    """The model. Parameters stay fp32; activations are stored in
    cfg.compute_dtype, BN math runs in fp32. `device` defaults to the CUDA
    card (`default_device()`). The modules take `train` explicitly, as the
    JAX package's do, so the module's train/eval mode changes no number."""

    def __init__(self, cfg: DCNetConfig,
                 backbone_defs: Optional[Sequence[LayerDef]] = None,
                 device: DeviceLike = None):
        super().__init__()
        if cfg.trunk_quant not in ("off", "calib", "int8"):
            raise ValueError(f"trunk_quant is off, calib or int8, not {cfg.trunk_quant!r}")
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.compute_dtype)
        dt, emb, textdim = self.dtype, cfg.emb_size, cfg.textdim
        defs = tuple(backbone_defs) if backbone_defs is not None \
            else yolov3_layer_defs()
        captured = [ld.in_filters for ld in defs if ld.type == "yoloconvolutional"]

        self.visumodel = DarknetBackbone(defs, device=device)
        if cfg.use_lstm:
            self.textmodel = BiLSTMEncoder(
                cfg.corpus_size, cfg.word_embedding_size, textdim // 2,
                textdim // 2, cfg.input_dropout, dtype=dt, device=device)
        else:  # frozen body; `proj` maps its context to emb_size
            self.textmodel = BertEncoder(cfg.bert_model, proj_dim=emb,
                                         dtype=dt, device=device)
        self.sub_attn = PhraseAttention(textdim, dtype=dt, device=device)
        self.loc_attn = PhraseAttention(textdim, dtype=dt, device=device)
        self.loc_embedding = DenseBNReLU(8, 8, dtype=dt, device=device)
        self.loc_text_embedding = DenseBNReLU(
            cfg.all_positions, emb, dtype=dt, device=device)
        q = cfg.trunk_quant
        self.mapping_visu = nn.ModuleList(
            ConvBNReLU(c, emb, 1, dtype=dt, quant=q, device=device) for c in captured)
        self.mapping_lang = MappingLang(textdim, emb, cfg.jemb_dropout,
                                        dtype=dt, device=device)
        self.corr_conv = nn.ModuleList(
            nn.Sequential(ConvBNReLU(2 * emb, emb, 1, dtype=dt, quant=q,
                                     device=device))
            for _ in range(3))
        # Conv1d word-patch smoothing of the cross-modal pairs (training)
        self.feature_map = nn.Sequential(nn.Conv1d(
            cfg.query_len, cfg.query_len, 3, padding=1, device=device))
        fcns = [build_fusion_fcn(2 * emb + 8, emb, cfg.light, dtype=dt,
                                 quant=q, device=device) for _ in range(3)]
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

    def map_features(self, raw: Sequence[torch.Tensor],
                     train: bool = False) -> List[torch.Tensor]:
        """Per-scale mapping + channel l2-norm over raw backbone maps."""
        return [l2_normalize(self.mapping_visu[i](raw[i], train=train))
                for i in range(3)]

    @trace_annotation("dcnet.extract")
    @torch.no_grad()
    def extract_features(self, images) -> List[torch.Tensor]:
        """Backbone + mapping: NHWC images (N, H, W, 3) -> per scale
        (N, g, g, C) mapped, l2-normalised features."""
        images = on_device(images, self.device)
        return self.map_features(self.visumodel(images, self.dtype))

    def _tp(self) -> bool:
        """cfg.tp_internals on a mesh whose model axis has more than one
        rank: the co-attention's query rows split over the model group."""
        return self.cfg.tp_internals and mesh.model_group() is not None

    def _coattn(self, f1: torch.Tensor, f2: torch.Tensor):
        """Both directions: K2, or its row windows under `_tp`."""
        t = self.cfg.coattn_temperature
        if self._tp():
            return coattention_pair(f1, f2, t, tp_shard=True)
        return coattention_pair_fused(f1, f2, t)

    def _coattn_center(self, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        """The center direction: K1, or its row windows under `_tp`."""
        t = self.cfg.coattn_temperature
        if self._tp():
            return coattention_center(f1, f2, t, tp_shard=True)
        return coattention_center_fused(f1, f2, t)

    @trace_annotation("dcnet.language")
    def _language(self, word_ids: torch.Tensor, train: bool = False):
        raw_flang, context, embedded = self.textmodel(word_ids, train=train)
        return (l2_normalize(self.mapping_lang(raw_flang, train=train)),
                context, embedded)

    @torch.no_grad()
    def encode_language(self, word_ids):
        """(flang (B, C) mapped + normalised, context, embedded)."""
        return self._language(torch.as_tensor(word_ids, device=self.device))

    def _dequantize(self, x: torch.Tensor) -> torch.Tensor:
        """An int8 ring frame (l2-normalised features quantised with the
        static scale 1/127) in the compute dtype: x * (1/127) with the scale
        rounded to the compute dtype first, as the JAX package applies a
        Python float to a bf16 array. Float frames pass through."""
        if x.dtype != torch.int8:
            return x
        return x.to(self.dtype) * torch.tensor(1.0 / 127.0, dtype=self.dtype)

    @trace_annotation("dcnet.corr")
    @torch.no_grad()
    def corr_features(self, per_frame: Sequence[torch.Tensor],
                      center: Optional[int] = None,
                      newest_slot: Optional[int] = None) -> List[torch.Tensor]:
        """Center-vs-each-reference co-attention + corr_conv, l2-normalised
        and averaged over the references. per_frame: per scale
        (B, n_frame, h, w, C), float or int8; see `eval_features` for
        `newest_slot`. With cfg.coattn_multiref one K4 launch per scale
        reads every reference off the ring in place and returns them
        stacked; with cfg.coattn_batch_refs one batched einsum does, and
        with cfg.coattn_int8_logits (alone) one einsum per reference on
        int8 logits; otherwise the center attends to each reference
        through K1."""
        cfg = self.cfg
        n_frame = per_frame[0].shape[1]
        center = n_frame // 2 if center is None else center
        cen_slot, ref_slots = ring_slots(n_frame, center, newest_slot)

        corr_feat = []
        for i in range(3):
            ring = per_frame[i]
            cen = self._dequantize(ring[:, cen_slot])
            if cfg.coattn_multiref:  # stacked (B, R, h, w, C), temporal order
                atts = coattention_ring_fused(
                    ring, cfg.coattn_temperature, center_t=center,
                    newest_slot=newest_slot).to(cen.dtype)
            elif cfg.coattn_batch_refs:  # stacked, one product over all refs
                refs = torch.stack([self._dequantize(ring[:, j]) for j in ref_slots],
                                   dim=1)
                atts = coattention_center_batched(
                    cen, refs, cfg.coattn_temperature,
                    int8_logits=cfg.coattn_int8_logits)
            elif cfg.coattn_int8_logits:
                atts = [coattention_center(cen, self._dequantize(ring[:, j]),
                                           cfg.coattn_temperature,
                                           tp_shard=cfg.tp_internals, int8_logits=True)
                        for j in ref_slots]
            else:
                atts = [self._coattn_center(cen, self._dequantize(ring[:, j]))
                        for j in ref_slots]
            conv = self.corr_conv[i][0]
            if cfg.split_corr_conv:  # center half of the 1x1 contraction once
                cfs = conv((cen, atts))
            else:
                if isinstance(atts, torch.Tensor):
                    atts = list(atts.unbind(1))
                cfs = [conv(torch.cat([cen, a], dim=-1)) for a in atts]
            if isinstance(cfs, list):
                acc = None
                for cf in cfs:
                    cf = l2_normalize(cf)
                    acc = cf if acc is None else acc + cf
                corr_feat.append(acc / len(ref_slots))
            else:  # stacked (B, R, h, w, F) from the split conv
                corr_feat.append(l2_normalize(cfs).mean(dim=1))
        return corr_feat

    @trace_annotation("dcnet.trunk")
    def _trunk(self, corr_feat: Sequence[torch.Tensor], flang: torch.Tensor,
               context: torch.Tensor, embedded: torch.Tensor,
               word_ids: torch.Tensor, train: bool = False):
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
                               self.dtype, train=train)
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
        coord_emb = self.loc_embedding(coord_map.reshape(-1, 8), train=train)
        coord_emb = l2_normalize(coord_emb.reshape(b, -1, 8), dim=2)
        rel = self.loc_text_embedding(None, gram_factors=(coord_emb, obj_map),
                                      train=train)
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

        # confidence modulation: conf *= sim * loc (out of place, for autograd)
        modulated = []
        for ob, ss, ls in zip(outbox, sim_score, loc_score):
            conf = (ob[:, :, 4] * (ss * ls)[:, None]).to(ob.dtype)
            modulated.append(torch.cat([ob[:, :, :4], conf[:, :, None]], dim=2))
        return modulated, sim_score, loc_score, only_obj, flang_attn

    # ------------------------------------------------------------------
    # training forward: interleaved k-frame clips
    # ------------------------------------------------------------------

    def _backbone(self, images: torch.Tensor, train: bool) -> List[torch.Tensor]:
        """The backbone's three captured maps. With cfg.remat_backbone and
        gradients on, its activations are recomputed in the backward
        (`torch.utils.checkpoint`) instead of kept; the recompute leaves
        the BatchNorm running statistics as the forward left them."""
        if not (self.cfg.remat_backbone and torch.is_grad_enabled()):
            return self.visumodel(images, self.dtype, train=train)
        calls = []

        def run(x):
            calls.append(None)
            if len(calls) == 1:
                return tuple(self.visumodel(x, self.dtype, train=train))
            with running_stats_frozen(self.visumodel):
                return tuple(self.visumodel(x, self.dtype, train=train))

        return list(checkpoint(run, images, use_reentrant=False))

    def forward(self, images: torch.Tensor, word_ids: torch.Tensor,
                train: bool = True,
                generator: Optional[torch.Generator] = None) -> TrainOutputs:
        """images: NHWC (kB, H, W, 3), clips frame-contiguous; word_ids
        (kB, L). k = cfg.n_frames_train. k=2 co-attends the two frames of
        each clip in both directions (K2); k>2 ring-pairs frame j with frame
        (j+1) mod k (K1), which is the k=2 dataflow at k=2. `train` takes
        batch statistics and dropout; `generator` draws the contrastive
        negatives (the device's default generator when None)."""
        cfg = self.cfg
        k_frames = cfg.n_frames_train
        images = torch.as_tensor(images, device=self.device)
        word_ids = torch.as_tensor(word_ids, device=self.device)
        bk = images.shape[0]
        b = bk // k_frames
        fvisu = self.map_features(self._backbone(images, train), train)

        corr_feat = []
        if k_frames == 2:
            input1 = [f.reshape(b, 2, *f.shape[1:])[:, 0] for f in fvisu]
            input2 = [f.reshape(b, 2, *f.shape[1:])[:, 1] for f in fvisu]
            interframe = interframe_pairs(
                input1[0], input2[0], cfg.interframe_top_k,
                cfg.interframe_neg_n, generator)
            for i in range(3):
                a1, a2 = self._coattn(input1[i], input2[i])
                c1 = torch.cat([input1[i], a1], dim=-1)     # (B, h, w, 2C)
                c2 = torch.cat([input2[i], a2], dim=-1)
                both = torch.stack([c1, c2], dim=1).reshape(bk, *c1.shape[1:])
                corr_feat.append(l2_normalize(self.corr_conv[i][0](both, train=train)))
        else:
            def ring_next(f):
                per_clip = f.reshape(b, k_frames, *f.shape[1:])
                return torch.roll(per_clip, -1, dims=1).reshape(bk, *f.shape[1:])

            interframe = interframe_pairs(
                fvisu[0], ring_next(fvisu[0]), cfg.interframe_top_k,
                cfg.interframe_neg_n, generator)
            for i in range(3):
                att = self._coattn_center(fvisu[i], ring_next(fvisu[i]))
                cf = self.corr_conv[i][0](torch.cat([fvisu[i], att], dim=-1),
                                          train=train)
                corr_feat.append(l2_normalize(cf))

        flang, context, embedded = self._language(word_ids, train)
        outbox, sim_score, loc_score, only_obj, flang_attn = self._trunk(
            corr_feat, flang, context, embedded, word_ids, train)

        # cross-modal correspondence on the coarsest scale: patch-normalised
        # visual patches against the nearest-downsampled language context,
        # the word-patch map smoothed by the Conv1d over patches and
        # softmaxed over words
        vit = l2_normalize(fvisu[0].reshape(bk, -1, cfg.emb_size).transpose(1, 2),
                           dim=2)                          # (kB, C, P)
        # the BiLSTM's context halved by nearest x0.5; BERT's projection
        lang = l2_normalize(context[:, :, ::2] if cfg.use_lstm else embedded,
                            dim=1)                         # (kB, L, C)
        wp_map = torch.einsum("blc,bcp->blp", lang, vit.to(lang.dtype))
        conv = self.feature_map[0]
        wp_map = torch.softmax(F.conv1d(wp_map, conv.weight.to(wp_map.dtype),
                                        conv.bias.to(wp_map.dtype), padding=1),
                               dim=1)
        crossmodal = crossmodal_pairs(
            wp_map, lang, vit.transpose(1, 2), cfg.crossmodal_top_k,
            cfg.crossmodal_neg_n, generator)
        return TrainOutputs(
            outbox=outbox, sim_score=sim_score, loc_score=loc_score,
            corr_feat=corr_feat, flang_attn=flang_attn, interframe=interframe,
            crossmodal=crossmodal, only_obj=only_obj)

    # ------------------------------------------------------------------
    # inference forward: n-frame clip, center-frame prediction
    # ------------------------------------------------------------------

    @torch.no_grad()
    def eval_features(self, per_frame: Sequence[torch.Tensor], word_ids,
                      center: Optional[int] = None,
                      language: Optional[Tuple[torch.Tensor, ...]] = None,
                      newest_slot: Optional[int] = None) -> EvalOutputs:
        """Trunk over pre-extracted per-frame features (per scale
        (B, n_frame, h, w, C), float or int8); word_ids (B, L). Pass
        `language` = (flang, context, embedded) to skip the text encoder.

        newest_slot: the serving engine's rotating ring stores frames in
        modular order (newest in slot `newest_slot`, oldest right after it)
        instead of shifting the buffer each tick: temporal frame j (0 =
        oldest) lives in physical slot (newest_slot + 1 + j) mod n_frame. A
        host integer, so reading the ring syncs nothing. None = physical
        order is temporal order (offline eval)."""
        word_ids = on_device(word_ids, self.device)
        corr_feat = self.corr_features(per_frame, center=center,
                                       newest_slot=newest_slot)
        if language is None:
            language = self._language(word_ids)
        flang, context, embedded = language
        outbox, sim_score, loc_score, only_obj, _ = self._trunk(
            corr_feat, flang, context, embedded, word_ids)
        return EvalOutputs(outbox=outbox, sim_score=sim_score,
                           loc_score=loc_score, corr_feat=corr_feat,
                           only_obj=only_obj)

    @trace_annotation("dcnet.eval_clip")
    @torch.no_grad()
    def eval_clip(self, images, word_ids, n_frame: int = 5) -> EvalOutputs:
        """images: NHWC (B*n_frame, H, W, 3), clips frame-contiguous;
        word_ids: (B, L), the center frame's phrase. Predictions for the
        center frame of each clip."""
        fvisu = self.extract_features(images)
        b = fvisu[0].shape[0] // n_frame
        per_frame = [f.reshape(b, n_frame, *f.shape[1:]) for f in fvisu]
        return self.eval_features(per_frame, word_ids)

    # ------------------------------------------------------------------
    # correspondence-free baseline: single image
    # ------------------------------------------------------------------

    @torch.no_grad()
    def single_image(self, images, word_ids) -> EvalOutputs:
        """The semantic-attention baseline: fusion and subject/location
        attention on the mapped features of each image, where the full model
        uses the correspondence features. images: NHWC (B, H, W, 3);
        word_ids (B, L)."""
        fvisu = self.extract_features(images)
        word_ids = torch.as_tensor(word_ids, device=self.device)
        flang, context, embedded = self._language(word_ids)
        outbox, sim_score, loc_score, only_obj, _ = self._trunk(
            fvisu, flang, context, embedded, word_ids)
        return EvalOutputs(outbox=outbox, sim_score=sim_score,
                           loc_score=loc_score, corr_feat=fvisu,
                           only_obj=only_obj)
