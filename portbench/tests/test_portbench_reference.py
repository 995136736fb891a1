"""The frozen plain reference against the program's own plain path at small
sizes on the CPU: the same weights' names and shapes, one served tick, one
eval call and one training step. (The test imports the program; the
reference does not.)"""

import pytest
import torch

from portbench import inputs
from portbench.reference import model as M
from portbench.reference import tasks
from portbench.reference.geometry import geometry_from, load_geometry
from portbench.tests import mini
from portbench.weights import make_weights


def geometry(encoder: str):
    path = f"portbench/configs/dcnet-vid-{encoder}.json"
    return geometry_from(__import__("json").load(open(path)),
                         **mini.geometry("bert" if encoder == "bert" else "bilstm"))


def program(g, dtype="float32", **opts):
    from portbench.program import build_model
    traffic = {"program": dict(compute_dtype=dtype, **opts)}
    W = make_weights(M.param_spec(g), 5, "cpu")
    return W, build_model(g, traffic, W, "cpu")


@pytest.mark.parametrize("encoder", ["bilstm", "bert"])
def test_param_spec_is_the_programs_state_dict(encoder):
    g = geometry(encoder)
    _, model = program(g)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {p.name: p.shape for p in M.param_spec(g)}


@pytest.mark.parametrize("encoder", ["bilstm", "bert"])
def test_full_size_spec_matches_too(encoder):
    """At the configurations' own sizes, on the meta device."""
    from dcnet_tpu_torch.models.darknet import yolov3_layer_defs
    from dcnet_tpu_torch.models.dcnet import DCNet

    from portbench.program import program_config
    g = load_geometry(f"portbench/configs/dcnet-vid-{encoder}.json")
    model = DCNet(program_config(g, {}), backbone_defs=yolov3_layer_defs(), device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {p.name: p.shape for p in M.param_spec(g)}


def test_one_eval_call():
    g = geometry("bert")
    W, model = program(g)
    gen = torch.Generator().manual_seed(3)
    clips = inputs.frames(gen, 2 * 5, g.image_size, "cpu")
    ids = inputs.bert_phrases(gen, 2, g.query_len, g.bert.vocab_size, 4, 18, "cpu")
    from dcnet_tpu_torch.ops.decode import decode_best
    with torch.no_grad():
        out = model.eval_clip(clips, ids, n_frame=5)
        dec = decode_best(out.outbox, model.cfg)
    ref = tasks.evaluate(W, g, clips.reshape(2, 5, *clips.shape[1:]), ids)
    assert torch.allclose(dec.boxes[:, 0], ref["box"], atol=1e-3)
    assert torch.allclose(dec.score[:, 0], ref["score"], rtol=1e-4, atol=1e-6)


def test_one_served_tick():
    from dcnet_tpu_torch.serving.engine import GroundingEngine
    g = geometry("bilstm")
    W, model = program(g, coattn_multiref=True, split_corr_conv=False)
    eng = GroundingEngine(model, 2)
    gen = torch.Generator().manual_seed(4)
    ids = inputs.corpus_phrases(gen, 2, g.query_len, g.corpus_size, 12, 20, "cpu")
    frames = inputs.frames(gen, 9 * 2, g.image_size, "cpu").reshape(9, 2, *([g.image_size] * 2), 3)
    state = eng.init_state(ids)
    for t in range(9):
        state, fused, raw, score = eng.step(state, frames[t])
    ref = tasks.serve(W, g, frames.transpose(0, 1), ids, torch.full((2,), 9), 5)
    assert torch.allclose(raw, ref["raw_box"], atol=1e-3)
    assert torch.allclose(score, ref["raw_score"], rtol=1e-4, atol=1e-6)
    assert torch.allclose(fused, ref["fused_box"], atol=1e-3)


def test_first_training_steps():
    torch.set_num_threads(2)
    r = mini.run("train-bilstm-32clip-fp32", seconds=0)
    checked = {k: v["value"] for k, v in r["checked"].items()}
    assert checked["loss1_rel"] < 1e-5 and checked["grad_rel"] < 1e-4
    assert checked["change_rel"] < 1e-2
    # the window's checked step, taken by the reference from the program's state
    assert checked["step_loss_rel"] < 1e-5 and checked["step_change_rel"] < 1e-2

