"""The port's eval CLIs against the JAX package's, in-process on the CPU.

Both packages evaluate the committed tiny lock (`tests/locks/
converge32tiny.npz`: mini defs, 64 px, emb / hidden 256) over the same 10
rows of the `data/synthetic32` test split, regenerated from seed 13 into a
temporary directory. The JAX CLIs get the lock from the npz in memory
(their `restore_checkpoint` is patched, as `tests/test_torch_lock.py` fills
its state) and the split through a patched `build_dataset`, as
`tests/test_cli.py` does; the port's CLIs run with `DCNET_PLATFORM=cpu`
and `--resume` the npz. Held: acc@0.5 within 1e-6 and mIoU within 2e-3 (the
limits of the JAX package's own lock tests) for the standard eval,
`--stream_eval`, `--post_process`, `cli/post_process.py` and
`cli/eval_single.py`; the `--cache` arrays match with equal top-k order,
scores within rtol 1e-4 / atol 1e-5 and boxes within 1e-3 px. Also
`DCNet.single_image` against JAX's on mini defs in fp32, and each option the
port does not run yet raises. The int8 CLI: `--quant --quant_params` on a
file the JAX package's `--quant` wrote gives its acc (1e-6) and mIoU
(2e-3); the port's own `--quant`, `--quant --quant_trunk`, `--coattn_int8`
and `--coattn_batch_refs` stay within the JAX package's limits of float
(`tests/test_cli.py`: mIoU 0.03, acc 0.11).
"""

import contextlib
import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcnet_tpu.cli.common as jcommon
import dcnet_tpu.cli.eval_single as jsingle
import dcnet_tpu.cli.post_process as jpost
import dcnet_tpu.cli.test as jtest
import dcnet_tpu_torch.cli.common as pcommon
import dcnet_tpu_torch.cli.eval_single as psingle
import dcnet_tpu_torch.cli.post_process as ppost
import dcnet_tpu_torch.cli.test as ptest
from dcnet_tpu.data.synthetic import generate_synthetic_vid
from dcnet_tpu.models.dcnet import DCNet as JaxDCNetCls
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.models.darknet import mini_backbone_defs
from dcnet_tpu_torch.models.dcnet import DCNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(REPO, "tests", "locks", "converge32tiny.npz")
ROWS = 10
ACC_TOL, MIOU_TOL = 1e-6, 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _limited(build):
    def build_dataset(*args, **kwargs):
        ds, corpus = build(*args, **kwargs)
        ds.chunks = ds.chunks[:ROWS]
        return ds, corpus
    return build_dataset


def _jax_build_dataset(root):
    """The JAX package's synthetic VIDDataset over `root`, as
    tests/test_cli.py builds it."""
    def build_dataset(args, split, testmode=False, num_frame_k=None):
        from dcnet_tpu.data.synthetic import build_synthetic_corpus
        from dcnet_tpu.data.vid import VIDDataset
        k = num_frame_k if num_frame_k is not None else args.num_frame_k
        corpus = build_synthetic_corpus()
        ds = VIDDataset(os.path.join(root, f"VID_video_level_{split}.json"),
                        corpus, split=split, imsize=args.size, num_frame_k=k,
                        max_query_len=args.time, testmode=testmode,
                        image_root=root, seed=args.seed)
        return ds, corpus
    return build_dataset


@dataclasses.dataclass(frozen=True)
class _Template:
    """What the JAX CLIs read of their TrainState: the variable trees."""
    params: dict
    batch_stats: dict

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _jax_template(model, cfg, *args, **kwargs):
    """Stands in for the JAX CLIs' create_train_state: the shapes of the
    model's variables (`jax.eval_shape` of its init, as
    tests/test_torch_lock.py takes them), which `_jax_restore` fills."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((2, cfg.image_size, cfg.image_size, 3), jnp.float32),
        jnp.zeros((2, cfg.query_len), jnp.int32), train=False))
    return _Template(shapes["params"], shapes["batch_stats"])


def _jax_restore(path, state, with_opt_state=False):
    """Fill the JAX CLI's state from the lock npz in memory, leaf by leaf
    as tools/lock_pack.py unpacks it."""
    z = np.load(LOCK)

    def fill(tree, prefix):
        def leaf(p, x):
            key = prefix + "/" + "/".join(k.key for k in p)
            assert z[key].shape == x.shape, key
            return jnp.asarray(z[key].astype(x.dtype))
        return jax.tree_util.tree_map_with_path(leaf, tree)
    return (state.replace(params=fill(state.params, "params"),
                          batch_stats=fill(state.batch_stats, "bstats")), None, None)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _metrics(text, prefix=""):
    """(acc, miou) of the last `prefix acc,miou` line."""
    for line in reversed(text.strip().splitlines()):
        if line.startswith(prefix) and ("post_process" in line) == bool(prefix):
            acc, miou = line[len(prefix):].strip().split(",")
            return float(acc), float(miou)
    raise AssertionError(f"no {prefix!r} metrics line in {text!r}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every CLI run of both packages, once."""
    work = tmp_path_factory.mktemp("cli")
    root = str(work / "synthetic")   # the port reads <split_root>/synthetic
    generate_synthetic_vid(root, "test", num_videos=32, frames_per_video=8, seed=13)
    common = ["--synthetic", "--lstm", "--mini", "--size", "64",
              "--emb_size", "256", "--lstm_hidden", "256", "--seed", "13",
              "--num_frame_k", "5", "--batch_size", "5", "--workers", "0",
              "--split_root", str(work), "--resume", LOCK]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)  # ./logs of setup_logging
        mp.setenv("DCNET_PLATFORM", "cpu")
        jbuild = _limited(_jax_build_dataset(root))
        mp.setattr(jtest, "build_dataset", jbuild)
        mp.setattr(jcommon, "build_dataset", jbuild)
        for mod in (jtest, jsingle):
            mp.setattr(mod, "create_train_state", _jax_template)
            mp.setattr(mod, "restore_checkpoint", _jax_restore)
        pbuild = _limited(pcommon.build_dataset)
        for mod in (ptest, psingle, pcommon):
            mp.setattr(mod, "build_dataset", pbuild)

        for name, pkg in (("jax", (jtest, jpost, jsingle)),
                          ("port", (ptest, ppost, psingle))):
            test, post, single = pkg
            cache = ["--cache_dir", str(work / name), "--savename", "lock"]
            with jax.default_matmul_precision("highest"):
                out[name] = {
                    "standard": _run(test.main, common + cache + [
                        "--cache", "--post_process", "--ref_cache_format"]),
                    "stream": _run(test.main, common + ["--stream_eval",
                                                        "--post_process"]),
                    "post": _run(post.main, common + cache),
                    "ref_cache": _run(post.main, common + cache + ["--ref_cache"]),
                    "single": _run(single.main, common),
                }
            out[name]["cache"] = dict(np.load(str(work / name / "lock" / "cache.npz"),
                                              allow_pickle=True))
    return out


@pytest.mark.parametrize("run,prefix", [
    ("standard", ""), ("standard", "post_process:"), ("stream", ""),
    ("stream", "post_process:"), ("post", ""), ("ref_cache", ""),
    ("single", "")])
def test_cli_metrics_match_jax(runs, run, prefix):
    jacc, jmiou = _metrics(runs["jax"][run], prefix)
    acc, miou = _metrics(runs["port"][run], prefix)
    assert abs(acc - jacc) < ACC_TOL, (run, prefix, acc, jacc)
    assert abs(miou - jmiou) < MIOU_TOL, (run, prefix, miou, jmiou)


@pytest.fixture(scope="module")
def quant_runs(runs, tmp_path_factory):
    """The int8 CLI runs: the JAX package's --quant writing its qparams,
    the port's --quant reading that file; the port's own calibration with
    and without --quant_trunk; the port's --coattn_int8 and
    --coattn_batch_refs."""
    work = tmp_path_factory.mktemp("quant")
    root = str(work / "synthetic")
    generate_synthetic_vid(root, "test", num_videos=32, frames_per_video=8, seed=13)
    common = ["--synthetic", "--lstm", "--mini", "--size", "64",
              "--emb_size", "256", "--lstm_hidden", "256", "--seed", "13",
              "--num_frame_k", "5", "--batch_size", "5", "--workers", "0",
              "--split_root", str(work), "--resume", LOCK, "--calib_frames", "16"]
    qfile = str(work / "jax_qparams.npz")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        mp.setenv("DCNET_PLATFORM", "cpu")
        jbuild = _limited(_jax_build_dataset(root))
        mp.setattr(jtest, "build_dataset", jbuild)
        mp.setattr(jcommon, "build_dataset", jbuild)
        mp.setattr(jtest, "create_train_state", _jax_template)
        mp.setattr(jtest, "restore_checkpoint", _jax_restore)
        pbuild = _limited(pcommon.build_dataset)
        for mod in (ptest, pcommon):
            mp.setattr(mod, "build_dataset", pbuild)
        with jax.default_matmul_precision("highest"):
            out["jax_quant"] = _run(jtest.main, common + ["--quant", "--quant_params", qfile])
        assert os.path.exists(qfile)
        out["port_jax_file"] = _run(ptest.main, common + ["--quant", "--quant_params", qfile])
        out["port_quant"] = _run(ptest.main, common + ["--quant"])
        out["port_quant_trunk"] = _run(ptest.main, common + ["--quant", "--quant_trunk"])
        out["port_coattn_int8"] = _run(ptest.main, common + ["--coattn_int8"])
        out["port_coattn_batch_refs"] = _run(ptest.main, common + ["--coattn_batch_refs"])
    return out


def test_quant_cli_with_jax_qparams_matches_jax(quant_runs):
    """--quant --quant_params <the JAX package's file>: acc equal and mIoU
    within 2e-3 of the JAX package's int8 CLI."""
    jacc, jmiou = _metrics(quant_runs["jax_quant"])
    acc, miou = _metrics(quant_runs["port_jax_file"])
    assert abs(acc - jacc) < ACC_TOL and abs(miou - jmiou) < MIOU_TOL, (acc, miou, jacc, jmiou)


@pytest.mark.parametrize("run", ["port_quant", "port_quant_trunk", "port_coattn_int8",
                                 "port_coattn_batch_refs"])
def test_quant_cli_close_to_float(runs, quant_runs, run):
    """The port's own int8 runs stay within the JAX package's limits of its
    float eval on the lock (`tests/test_cli.py`: mIoU 0.03, acc 0.11)."""
    facc, fmiou = _metrics(runs["port"]["stream" if "quant" in run else "standard"])
    acc, miou = _metrics(quant_runs[run])
    assert fmiou > 0.05
    assert abs(miou - fmiou) < 0.03 and abs(acc - facc) < 0.11, (run, acc, miou, facc, fmiou)


def test_lock_grounds_through_the_port(runs):
    """Trained weights ground something (the JAX package's own check), and
    stream eval reproduces the standard eval."""
    acc, miou = _metrics(runs["port"]["standard"])
    sacc, smiou = _metrics(runs["port"]["stream"])
    assert miou > 0.05
    assert abs(acc - sacc) < ACC_TOL and abs(miou - smiou) < MIOU_TOL


def test_cache_npz_matches_jax(runs):
    want, got = runs["jax"]["cache"], runs["port"]["cache"]
    assert set(got) == set(want)
    assert got["boxes"].shape == want["boxes"].shape == (ROWS, 5, 4)
    # equal top-k order: each row's scores descend alike and match
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-5)
    assert np.array_equal(np.argsort(-got["scores"], 1, kind="stable"),
                          np.argsort(-want["scores"], 1, kind="stable"))
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["feats"], want["feats"], rtol=1e-4, atol=1e-5)
    for key in ("gt_boxes", "ratios", "dws", "dhs", "video_ids"):
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


def test_single_image_matches_jax():
    """DCNet.single_image on the lock's weights (mini defs, fp32) against
    JAX's, at the limits of tests/test_torch_slice.py."""
    from dcnet_tpu_torch.weights import load_lock_into

    args = jcommon.base_parser("lock").parse_args(
        ["--synthetic", "--lstm", "--mini", "--size", "64", "--emb_size", "256",
         "--lstm_hidden", "256"])
    jcfg = jcommon.config_from_args(args, corpus_size=15)
    jmodel = jcommon.build_model(args, jcfg)
    state, _, _ = _jax_restore(LOCK, _jax_template(jmodel, jcfg))
    model = pcommon.build_model(args, pcommon.config_from_args(args, corpus_size=15),
                                torch.device("cpu"))
    load_lock_into(model, LOCK)
    rng = np.random.RandomState(3)
    images = rng.rand(3, 64, 64, 3).astype(np.float32)
    ids = rng.randint(1, 15, (3, 20)).astype(np.int32)
    fn = jax.jit(lambda p, b, x, w: jmodel.apply(
        {"params": p, "batch_stats": b}, x, w, method=JaxDCNetCls.single_image))
    with jax.default_matmul_precision("highest"):
        jout = fn(state.params, state.batch_stats, jnp.asarray(images), jnp.asarray(ids))
    out = model.single_image(torch.from_numpy(images), torch.from_numpy(ids))
    for field in ("outbox", "sim_score", "loc_score", "corr_feat", "only_obj"):
        for s in range(3):
            np.testing.assert_allclose(
                getattr(out, field)[s].numpy(), np.asarray(getattr(jout, field)[s]),
                rtol=1e-4, atol=1e-4, err_msg=f"{field}[{s}]")


@pytest.mark.parametrize("argv,item", [
    (["--quant"], "9"), (["--quant_trunk"], "9"), (["--coattn_int8"], "9"),
    (["--coattn_batch_refs"], "9"), ([], "10")])
def test_unported_cli_options_raise(tmp_path, monkeypatch, argv, item):
    """The int8 options of item 9 and the BERT encoder of item 10 (no
    `--lstm`) are ported and pass the option check (their runs are
    `test_quant_cli_*` and `tests/test_torch_bert.py`)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DCNET_PLATFORM", "cpu")
    lstm = ["--lstm"] if item != "10" else []
    args = ptest.parser().parse_args(["--synthetic", "--mini", "--size", "64"]
                                     + lstm + argv)
    ptest._check_options(args, torch.device("cpu"))
    assert args.lstm == (item != "10")


def test_data_parallel_over_cards_raises(tmp_path, monkeypatch):
    """--data_parallel runs one process a card (its runs are in
    tests/test_torch_parallel.py); it raises only where the processes it is
    asked for cannot start: more cards than there are, --multihost outside
    torchrun's launch, or --devices above 1 without --data_parallel."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ptest, "cli_device", lambda: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="--devices 3: 2 CUDA devices"):
        ptest.main(["--synthetic", "--lstm", "--data_parallel", "--devices", "3"])
    with pytest.raises(ValueError, match="torchrun"):
        ptest.main(["--synthetic", "--lstm", "--data_parallel", "--multihost"])
    with pytest.raises(ValueError, match="without --data_parallel runs one process"):
        ptest.main(["--synthetic", "--lstm", "--devices", "2"])


@pytest.mark.parametrize("resume,item", [
    ("dir", "11"), ("tests/locks/converge32tinybert.npz", "10")])
def test_unported_checkpoints_raise(tmp_path, resume, item):
    """An orbax checkpoint directory of the JAX package (item 11 reads the
    port's own directories) and a BERT lock (item 10: the lock leaves out
    the frozen body, which only the JAX package regenerates) raise, each
    naming the route through the JAX package."""
    model = DCNet(_config(emb=64), backbone_defs=mini_backbone_defs(), device="cpu")
    path = str(tmp_path) if resume == "dir" else os.path.join(REPO, resume)
    if resume == "dir":
        os.makedirs(tmp_path / "3")  # orbax: one directory a step
    with pytest.raises(NotImplementedError, match="JAX package.*state_dict_from_jax"):
        pcommon.restore_weights(path, model)


def test_resume_takes_a_reference_state_dict(tmp_path):
    """A `.pth.tar` holding {'state_dict': ...} (DDP `module.` keys) loads
    the same weights as the lock it was saved from."""
    from dcnet_tpu_torch.weights import load_lock_into
    a = DCNet(_config(), backbone_defs=mini_backbone_defs(), device="cpu")
    load_lock_into(a, LOCK)
    path = str(tmp_path / "model_best.pth.tar")
    torch.save({"epoch": 1, "state_dict": {f"module.{k}": v for k, v in
                                           a.state_dict().items()}}, path)
    b = DCNet(_config(), backbone_defs=mini_backbone_defs(), device="cpu")
    pcommon.restore_weights(path, b)
    for k, v in a.state_dict().items():
        assert torch.equal(b.state_dict()[k], v), k


def _config(emb=256):
    return DCNetConfig(image_size=64, emb_size=emb, lstm_hidden=emb,
                       word_embedding_size=emb, corpus_size=15)


def test_stream_eval_refuses_cache(tmp_path, monkeypatch):
    """The JAX CLI's stream eval writes no cache and says nothing; the
    port's refuses the combination."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DCNET_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="--cache"):
        ptest.main(["--synthetic", "--lstm", "--stream_eval", "--cache"])
