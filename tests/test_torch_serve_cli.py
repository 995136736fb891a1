"""`dcnet_tpu_torch.cli.serve` against `dcnet_tpu.cli.serve`, in-process on
the CPU.

Both CLIs serve the committed tiny BERT lock (`tests/locks/
converge32tinybert.npz`, mini defs, 64 px, emb 256, bert-mini; its frozen
body regenerated by the JAX package as `tests/test_torch_bert.py` does)
over the same two `--frames_root` streams of seven `.jpg` frames (cv2
decodes them on both sides), without `--lstm`: the BERT engine of each
package, tick by tick, raw and fused boxes and scores at the limits of
`tests/test_torch_serving.py` (boxes rtol 1e-4 / atol 1e-3 px, scores
rtol 1e-4 / atol 1e-5). The JAX CLI takes the lock's trees in memory (its
`create_train_state` and `restore_checkpoint` patched); the port's reads a
`.pth.tar` of the same weights through `--resume`.

Then the port's `--state_file`: a run stopped after 4 ticks (state written
every 2 ticks by the async writer, and at exit) and resumed to 7 serves
ticks 4-6 as an uninterrupted run does, bitwise, and ends in the same
state (with `--split_corr` and `--cast_params`).

And `cli/export.py`: the reference `.pth.tar` it writes from the committed
tiny lock equals the JAX package's `export_reference_state_dict` of the
lock, key for key and bitwise; `--from_reference` into a port checkpoint
directory and back is bitwise; an orbax directory raises.
"""

import contextlib
import io
import os

import cv2
import jax
import numpy as np
import pytest
import torch

import dcnet_tpu.cli.common as jcommon
import dcnet_tpu.cli.serve as jserve
import dcnet_tpu.train.checkpoint as jckpt
import dcnet_tpu.train.state as jstate
import dcnet_tpu_torch.cli.export as pexport
import dcnet_tpu_torch.cli.serve as pserve
from dcnet_tpu.data.synthetic import build_synthetic_corpus
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.models.darknet import mini_backbone_defs
from dcnet_tpu_torch.models.dcnet import DCNet
from dcnet_tpu_torch.serving.engine import load_stream_state
from dcnet_tpu_torch.weights import load_into, state_dict_from_jax
from tests.test_torch_bert import _restore_bert_lock
from tests.test_torch_cli import LOCK, _jax_restore, _jax_template

STREAMS, FRAMES = 2, 7
BOX_TOL = dict(rtol=1e-4, atol=1e-3)
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)
PHRASES = ("the small red box moving left", "the large blue box moving right")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Template:
    """What the JAX CLI reads of its TrainState: params and batch_stats."""

    def __init__(self, params=None, batch_stats=None):
        self.params, self.batch_stats = params, batch_stats

    def replace(self, **kw):
        return _Template(**{"params": self.params, "batch_stats": self.batch_stats, **kw})


def _recording(cls, ticks):
    class Recorded(cls):
        def step(self, state, frames):
            out = super().step(state, frames)
            ticks.append([np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)
                          for x in out[1:]])
            return out
    return Recorded


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve")
    rng = np.random.RandomState(3)
    for s, phrase in enumerate(PHRASES):
        d = work / "streams" / f"s{s}"
        os.makedirs(d)
        (d / "phrase.txt").write_text(phrase)
        for f in range(FRAMES):
            cv2.imwrite(str(d / f"{f:03d}.jpg"), rng.randint(0, 255, (80, 100, 3), np.uint8))
    jmodel, jcfg, params, bstats = _restore_bert_lock()
    port = DCNet(DCNetConfig(image_size=64, emb_size=256, lstm_hidden=256,
                             word_embedding_size=256, use_lstm=False,
                             bert_model="bert-mini", corpus_size=jcfg.corpus_size),
                 backbone_defs=mini_backbone_defs(), device="cpu")
    load_into(port, state_dict_from_jax(params, bstats))
    ckpt = str(work / "bert_lock.pth.tar")
    torch.save({"epoch": 0, "state_dict": port.state_dict()}, ckpt)

    argv = ["--frames_root", str(work / "streams"), "--mini", "--size", "64",
            "--emb_size", "256", "--lstm_hidden", "256", "--bert_model", "bert-mini",
            "--n_streams", str(STREAMS), "--ticks", str(FRAMES), "--print_every", "100"]
    ticks = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        mp.setenv("DCNET_PLATFORM", "cpu")
        mp.setattr(jstate, "create_train_state", lambda *a, **k: _Template())
        mp.setattr(jckpt, "restore_checkpoint", lambda path, st, **k: (
            st.replace(params=params, batch_stats=bstats), None, None))
        mp.setattr(jserve, "GroundingEngine",
                   _recording(jserve.GroundingEngine, ticks["jax"]))
        mp.setattr(pserve, "GroundingEngine",
                   _recording(pserve.GroundingEngine, ticks["port"]))
        with jax.default_matmul_precision("highest"):
            _run(jserve.main, argv + ["--resume", "lock"])
        _, text = _run(pserve.main, argv + ["--resume", ckpt])
    return ticks, text


def test_bert_serve_cli_matches_jax_tick_by_tick(served):
    ticks, text = served
    assert len(ticks["port"]) == len(ticks["jax"]) == FRAMES
    for t, (got, want) in enumerate(zip(ticks["port"], ticks["jax"])):
        np.testing.assert_allclose(got[0], want[0], **BOX_TOL, err_msg=f"fused, tick {t}")
        np.testing.assert_allclose(got[1], want[1], **BOX_TOL, err_msg=f"raw, tick {t}")
        np.testing.assert_allclose(got[2], want[2], **SCORE_TOL, err_msg=f"score, tick {t}")
    assert f"tick {FRAMES}/{FRAMES}:" in text
    assert f"served {STREAMS * FRAMES} predictions over {STREAMS} streams" in text


def test_state_file_resume_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DCNET_PLATFORM", "cpu")
    base = ["--synthetic", "--lstm", "--mini", "--size", "64", "--emb_size", "64",
            "--lstm_hidden", "64", "--n_streams", "3", "--print_every", "1",
            "--split_corr", "--cast_params"]
    ticks = []
    monkeypatch.setattr(pserve, "GroundingEngine", _recording(pserve.GroundingEngine, ticks))
    whole, _ = _run(pserve.main, base + ["--ticks", str(FRAMES)])
    uninterrupted = ticks[:]
    ticks.clear()
    _run(pserve.main, base + ["--ticks", "4", "--state_file", "s.npz", "--state_every", "2"])
    assert load_stream_state("s.npz", device="cpu").frames_seen.tolist() == [4] * 3
    resumed, text = _run(pserve.main, base + ["--ticks", str(FRAMES),
                                              "--state_file", "s.npz"])
    assert "resumed stream state from s.npz" in text and len(ticks) == FRAMES
    for t in range(4, FRAMES):
        for a, b in zip(ticks[t], uninterrupted[t]):
            assert np.array_equal(a, b), t
    for name in ("cache_boxes", "cache_scores", "cache_feats", "frames_seen"):
        assert torch.equal(getattr(resumed, name), getattr(whole, name)), name
    assert all(torch.equal(a, b) for a, b in zip(resumed.feat_rings, whole.feat_rings))
    assert resumed.slot == whole.slot


# --- cli/export.py ------------------------------------------------------------

def test_export_cli_writes_the_jax_reference_state_dict(tmp_path, monkeypatch):
    """The `.pth.tar` written from the committed lock equals the JAX
    package's `export_reference_state_dict` of the lock key for key and
    bitwise; --from_reference into a port checkpoint directory and back
    is bitwise; an orbax directory raises, naming the JAX route."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DCNET_PLATFORM", "cpu")
    argv = ["--synthetic", "--lstm", "--mini", "--size", "64", "--emb_size", "256",
            "--lstm_hidden", "256", "--split_root", str(tmp_path)]
    with contextlib.redirect_stdout(io.StringIO()):
        out = pexport.main(argv + ["--resume", LOCK, "--out", "lock.pth.tar"])
        imported = pexport.main(argv + ["--from_reference", out, "--out", "imported",
                                        "--epoch", "4"])
        again = pexport.main(argv + ["--resume", "imported", "--out", "again.pth.tar"])
    jargs = jcommon.base_parser("lock").parse_args(argv)
    jcfg = jcommon.config_from_args(jargs, corpus_size=len(build_synthetic_corpus()))
    jstate0 = _jax_restore(LOCK, _jax_template(jcommon.build_model(jargs, jcfg), jcfg))[0]
    want = jckpt.export_reference_state_dict(jstate0.params, jstate0.batch_stats)
    got = torch.load(out)["state_dict"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype and np.array_equal(got[k].numpy(), v), k
    assert imported == os.path.join("imported", "4.pth.tar")
    blob = torch.load(again)
    assert blob["epoch"] == 4 and sorted(blob["state_dict"]) == sorted(got)
    assert all(torch.equal(blob["state_dict"][k], v) for k, v in got.items())
    os.makedirs("orbax/3")
    with pytest.raises(NotImplementedError, match="JAX package.*state_dict_from_jax"):
        pexport.main(argv + ["--resume", "orbax", "--out", "x.pth.tar"])
