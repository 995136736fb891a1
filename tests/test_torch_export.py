"""The serving bundle (`dcnet_tpu_torch.serving.export`) and the registered
kernel operators, on the CPU.

- `torch.library.opcheck` on `dcnet::attend` (K1), `dcnet::ring` (K4),
  `dcnet::conv_s8` (K6) at a shape of each route `conv_plan` picks on the
  card (TMA with and without the quantize pass, halo, gather) and every
  epilogue kind, and `dcnet::conv_s8_quant`: schema, fake (meta)
  implementation against the real one's output metadata, and a dynamic
  trace. A real meta tensor is refused (the ops launch or raise; they never
  fall back).
- The exported tick against the live port engine it was exported from, tick
  by tick at 1e-4 (this mirrors `tests/test_serving.py:258-291`): 2 streams,
  n_frame 5, topk 3, fuse window 3, 8 ticks, so the one step program meets
  every slot value (and three of them twice). Two bundles: a float engine
  with int8 rings on K4 (`coattn_multiref`), and `cli/serve.py --quant
  --export_bundle` (int8 backbone and trunk, float rings, K1 per
  reference). A fresh subprocess loads both and serves them; it imports no
  `dcnet_tpu_torch.models` module. It also serves the float bundle with
  another model's `state_dict` loaded into its programs (what
  `ServingRuntime(state_dict=...)` does), against a live engine on that
  model.
- The BiLSTM form the language program needs (each direction unpacked, the
  backward one on sequences reversed within their lengths) against the
  packed encoder within 1e-6, gradients included.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dcnet_tpu_torch.cli.serve as pserve
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.kernels import coattn, conv_s8 as k6
from dcnet_tpu_torch.models.darknet import mini_backbone_defs
from dcnet_tpu_torch.models.dcnet import DCNet
from dcnet_tpu_torch.models.lstm import BiLSTMEncoder
from dcnet_tpu_torch.serving import export
from dcnet_tpu_torch.serving.engine import GroundingEngine
from dcnet_tpu_torch.weights import seeded_init_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(image_size=64, corpus_size=100, emb_size=64, lstm_hidden=64,
             word_embedding_size=64, use_lstm=True, split_corr_conv=False)
N, TICKS, TOPK, WINDOW = 2, 8, 3, 3
TOL = dict(rtol=0, atol=1e-4)
# the meta keys of the JAX package's bundle (dcnet_tpu/serving/export.py:99-107)
JAX_META = {"n_streams", "n_frame", "topk", "fuse_window", "grids", "emb_size",
            "query_len", "image_size", "quantized", "state_dtype", "platforms"}
OPCHECK_TESTS = ("test_schema", "test_faketensor", "test_aot_dispatch_dynamic")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _int8(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)


def _conv_case(route):
    """(args of dcnet::conv_s8) at a shape `conv_plan` sends to `route`."""
    gen = torch.Generator().manual_seed(1)
    shape = {"tma": (2, 8, 8, 64, 64, 3, 1, 1), "tma_quant": (2, 8, 8, 80, 64, 3, 1, 1),
             "halo": (2, 16, 16, 3, 32, 3, 1, 1), "gather": (2, 9, 9, 64, 64, 3, 2, 1)}[route]
    n, h, w, ci, co, k, stride, pad = shape
    x = (_int8(gen, n, h, w, ci) if route in ("tma", "gather")
         else torch.randn((n, h, w, ci), generator=gen))
    wq = _int8(gen, co, k, k, ci)
    vec = [torch.rand((co,), generator=gen) + 0.5 for _ in range(4)]
    in_inv = None if x.dtype == torch.int8 else 40.0
    plan = k6.conv_plan(n, h, w, ci, co, k, stride, pad,
                        x_dtype=str(x.dtype).replace("torch.", ""))
    assert plan.route == route.split("_")[0]
    epilogues = {  # int32 raw sums, fp32 leaky, the trunk's BN + ReLU to bf16,
        "tma": dict(),  # the int8 chain, an int32 addend
        "tma_quant": dict(scale=vec[0], bias=vec[1], act="leaky", out_dtype=torch.float32),
        "halo": dict(scale=vec[0], bias=vec[1], scale2=vec[2], bias2=vec[3], act="relu",
                     out_dtype=torch.bfloat16),
        "gather": dict(scale=vec[0], bias=vec[1], out_dtype=torch.int8, inv_out=30.0)}
    epi = epilogues[route]
    if route == "tma":
        ho = (h + 2 * pad - k) // stride + 1
        epi = dict(scale=vec[0], bias=vec[1], out_dtype=torch.float32,
                   addend=torch.randint(-99, 99, (n * ho * ho, co), generator=gen,
                                        dtype=torch.int32), addend_hw=ho * ho)
    full = dict(scale=None, bias=None, scale2=None, bias2=None, act=None,
                out_dtype=torch.int32, inv_out=None, addend=None, addend_hw=1,
                addend_rep=1, in_inv=in_inv, in_scale=None)
    full.update(epi)
    return (x, wq, stride, pad, *full.values())


@pytest.mark.parametrize("route", ["tma", "tma_quant", "halo", "gather"])
def test_conv_s8_op_passes_opcheck(route):
    args = _conv_case(route)
    torch.library.opcheck(torch.ops.dcnet.conv_s8.default, args, test_utils=OPCHECK_TESTS)
    got = torch.ops.dcnet.conv_s8(*args)
    assert torch.equal(got, k6.conv_s8_plain(*args[:4], **dict(zip(
        ("scale", "bias", "scale2", "bias2", "act", "out_dtype", "inv_out", "addend",
         "addend_hw", "addend_rep", "in_inv", "in_scale"), args[4:]))))


@pytest.mark.parametrize("op", ["attend", "attend_bf16", "ring", "ring_int8", "quant"])
def test_kernel_ops_pass_opcheck(op):
    gen = torch.Generator().manual_seed(2)
    if op.startswith("attend"):
        dt = torch.bfloat16 if op.endswith("bf16") else torch.float32
        q, kv = (torch.randn((2, 16, 8), generator=gen).to(dt) for _ in range(2))
        case = (torch.ops.dcnet.attend.default, (q, kv, 10.0))
    elif op.startswith("ring"):
        ring = (_int8(gen, 2, 5, 4, 8) if op.endswith("int8")
                else torch.randn((2, 5, 4, 8), generator=gen))
        case = (torch.ops.dcnet.ring.default, (ring, 10.0, 2, 3))
    else:
        case = (torch.ops.dcnet.conv_s8_quant.default,
                (torch.randn((2, 4, 4, 3), generator=gen), 16, 40.0, None))
    torch.library.opcheck(*case, test_utils=OPCHECK_TESTS)


def test_ops_refuse_meta_tensors():
    """A meta tensor is on no device the kernels run on: refused, as a
    CUDA call off the kernels' rules is (the fake implementation serves
    tracing only)."""
    ring = torch.zeros((1, 5, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattention_ring_fused(ring.reshape(1, 5, 2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        k6.conv_s8(torch.zeros((1, 4, 4, 16), dtype=torch.int8, device="meta"),
                   torch.zeros((8, 1, 1, 16), dtype=torch.int8))


def test_lstm_form_equals_the_packed_encoder():
    """`BiLSTMEncoder.unpacked`, the form the language program is exported
    in, against the packed encoder of the live path."""
    torch.manual_seed(0)
    enc = BiLSTMEncoder(50, 32, 24, 16, 0.0)
    ids = torch.randint(1, 50, (6, 20))
    for b, n in enumerate([20, 1, 7, 0, 13, 3]):
        ids[b, n:] = 0  # a full, a one-word, an empty (one token) phrase
    sent, want, emb = enc(ids)
    lengths = torch.clamp((ids != 0).sum(1), min=1)
    ctx = enc.unpacked(emb, lengths)
    torch.testing.assert_close(ctx, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(ctx[torch.arange(6), lengths - 1], sent, rtol=0, atol=1e-6)
    g = torch.randn(ctx.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad((ctx * g).sum(), enc.rnn.weight_hh_l0_reverse)[0]
    ref = torch.autograd.grad((want * g).sum(), enc.rnn.weight_hh_l0_reverse)[0]
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


# --- the bundle --------------------------------------------------------------

_SERVE = """
import json, sys
import numpy as np, torch
from dcnet_tpu_torch.serving import export
from dcnet_tpu_torch.serving.export import ServingRuntime
d = np.load(sys.argv[1])
out = {}
runtimes = {}
for name, bundle in json.loads(sys.argv[2]).items():
    if "state_dict" in bundle:  # the loaded programs, their weights replaced
        rt = runtimes[bundle["of"]]
        for prog in (rt._step, rt._lang):
            export._replace_weights(prog, torch.load(bundle["state_dict"]))
    else:
        rt = runtimes[name] = ServingRuntime(bundle["dir"], device="cpu")
    state = rt.init_state(torch.from_numpy(d["ids"]))
    for t in range(d["frames"].shape[0]):
        state, fused, raw, score = rt.step(state, torch.from_numpy(d["frames"][t]))
        for k, v in (("fused", fused), ("raw", raw), ("score", score)):
            out[f"{name}/{k}/{t}"] = v.numpy()
    out[f"{name}/slot"] = np.asarray(state.slot)
np.savez(sys.argv[3], **out)
# the step program as loaded: is its last input symbolic, which of its K4
# calls read it, which operators it calls
graphs = {}
for name, rt in runtimes.items():
    g = rt._step.graph
    slot = [n for n in g.nodes if n.op == "placeholder"][-1]

    def reads_slot(node):
        seen, todo = set(), list(node.all_input_nodes)
        while todo:
            n = todo.pop()
            if n is slot:
                return True
            if n not in seen:
                seen.add(n)
                todo += n.all_input_nodes
        return False
    calls = [n for n in g.nodes if n.op == "call_function"]
    graphs[name] = {"slot_symbolic": isinstance(slot.meta.get("val"), torch.SymInt),
                    "ring_calls_reading_slot": sum(
                        n.target == torch.ops.dcnet.ring.default and reads_slot(n)
                        for n in calls),
                    "ops": sorted({str(n.target) for n in calls
                                   if str(n.target).startswith("dcnet.")})}
print(json.dumps({"graphs": graphs, "modules": sorted(
    m for m in sys.modules if m.startswith("dcnet_tpu_torch"))}))
"""


def _model(seed, **over):
    cfg = DCNetConfig(**{**SMALL, **over})
    return seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(), device="cpu"),
                        seed=seed)


def _live(eng, frames, ids):
    state = eng.init_state(torch.from_numpy(ids))
    outs = []
    for t in range(frames.shape[0]):
        state, *o = eng.step(state, torch.from_numpy(frames[t]))
        outs.append([x.numpy() for x in o])
    return outs


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Both bundles, the live engines' ticks, the runtime's ticks (served in
    a fresh subprocess) and the modules that subprocess imported."""
    work = tmp_path_factory.mktemp("bundles")
    rng = np.random.RandomState(7)
    frames = rng.rand(TICKS, N, 64, 64, 3).astype(np.float32)
    ids = rng.randint(1, 12, (N, 20)).astype(np.int64)  # within the synthetic corpus
    ids[1, 9:] = 0  # a padded phrase
    np.savez(str(work / "inputs.npz"), frames=frames, ids=ids)

    # a float engine, int8 rings on K4
    eng = GroundingEngine(_model(3, coattn_multiref=True), n_streams=N, topk=TOPK,
                          fuse_window=WINDOW, int8_rings=True)
    called = {"step": 0, "_tick": 0}
    with pytest.MonkeyPatch.context() as mp:
        for name in called:
            real_fn = getattr(GroundingEngine, name)
            mp.setattr(GroundingEngine, name,
                       lambda self, *a, _n=name, _f=real_fn: called.update(
                           {_n: called[_n] + 1}) or _f(self, *a))
        meta = export.export_engine(eng, str(work / "float_multiref"))
    live = {"float_multiref": _live(eng, frames, ids)}
    other = GroundingEngine(_model(4, coattn_multiref=True), n_streams=N, topk=TOPK,
                            fuse_window=WINDOW, int8_rings=True)
    torch.save(other.model.state_dict(), str(work / "other.pt"))
    live["other_weights"] = _live(other, frames, ids)

    # the quantized K1 engine through cli/serve.py --quant --export_bundle
    made = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        mp.setenv("DCNET_PLATFORM", "cpu")
        real = export.export_engine
        mp.setattr(export, "export_engine",
                   lambda e, d, **kw: made.update(engine=e, meta=real(e, d, **kw)))
        assert pserve.main(["--synthetic", "--lstm", "--mini", "--size", "64",
                            "--emb_size", "64", "--lstm_hidden", "64", "--n_streams",
                            str(N), "--topk", str(TOPK), "--fuse_window", str(WINDOW),
                            "--ticks", str(TICKS), "--quant",
                            "--export_bundle", str(work / "quant_k1")]) is None
    live["quant_k1"] = _live(made["engine"], frames, ids)

    spec = {"float_multiref": {"dir": str(work / "float_multiref")},
            "quant_k1": {"dir": str(work / "quant_k1")},
            "other_weights": {"of": "float_multiref",
                              "state_dict": str(work / "other.pt")}}
    proc = subprocess.run([sys.executable, "-c", _SERVE, str(work / "inputs.npz"),
                           json.dumps(spec), str(work / "served.npz")],
                          capture_output=True, text=True, cwd=REPO, timeout=600,
                          env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    served = dict(np.load(str(work / "served.npz")))
    report = json.loads(proc.stdout.splitlines()[-1])
    return dict(live=live, served=served, modules=report["modules"], export_calls=called,
                graphs=report["graphs"], work=work,
                metas={"float_multiref": meta, "quant_k1": made["meta"]})


@pytest.mark.parametrize("name", ["float_multiref", "quant_k1", "other_weights"])
def test_runtime_serves_like_the_live_engine(bundles, name):
    for t, want in enumerate(bundles["live"][name]):
        for k, w in zip(("fused", "raw", "score"), want):
            np.testing.assert_allclose(bundles["served"][f"{name}/{k}/{t}"], w, **TOL,
                                       err_msg=f"{name} {k} tick {t}")
    assert int(bundles["served"][f"{name}/slot"]) == (TICKS - 1) % 5


def test_export_traces_the_eager_tick(bundles):
    """`export_engine` calls the engine's eager `_tick` (the warm-up and the
    trace), never `step`, which may replay CUDA graphs."""
    calls = bundles["export_calls"]
    assert calls["step"] == 0 and calls["_tick"] >= 2, calls


def test_runtime_imports_no_model_code(bundles):
    mods = bundles["modules"]
    assert "dcnet_tpu_torch.serving.export" in mods and "dcnet_tpu_torch.kernels" in mods
    assert not [m for m in mods if m.startswith("dcnet_tpu_torch.models")
                or m == "dcnet_tpu_torch.serving.engine"], mods


def test_one_step_program_takes_the_slot_as_an_input(bundles):
    """One program serves every slot value: its last input is a symbolic
    integer, and each of the tick's three K4 calls reads it."""
    multiref, quant = bundles["graphs"]["float_multiref"], bundles["graphs"]["quant_k1"]
    assert multiref["slot_symbolic"] and quant["slot_symbolic"]
    assert multiref["ring_calls_reading_slot"] == 3
    assert multiref["ops"] == ["dcnet.ring.default"]
    assert quant["ops"] == ["dcnet.attend.default", "dcnet.conv_s8.default"]


def test_meta_has_the_jax_bundles_keys(bundles):
    for name, meta in bundles["metas"].items():
        assert JAX_META <= set(meta), name
        assert meta["platforms"] == ["cpu"] and meta["n_streams"] == N
    assert bundles["metas"]["quant_k1"]["quantized"]
    assert bundles["metas"]["float_multiref"]["ring_dtype"] == "int8"


def test_bundle_refuses_another_device_kind(bundles):
    with pytest.raises(ValueError, match="exported for"):
        export.ServingRuntime(str(bundles["work"] / "float_multiref"), device="cuda")
