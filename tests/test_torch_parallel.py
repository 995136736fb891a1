"""Data parallelism of the port (`dcnet_tpu_torch.parallel.mesh`) on the CPU.

Two gloo processes over a `file://` store (no port):

- one k=2 train step of the mini model (64 px, dropout 0) on 4 clips, two
  a rank, through DistributedDataParallel with the global-batch BatchNorm,
  against the one-process port step on the 4 clips (which
  `tests/test_torch_train.py` holds against the JAX step): the losses and
  metrics within the limits of the JAX package's own data-parallel test
  (`tests/test_train.py::test_train_step_data_parallel`: loss rtol 1e-3;
  acc50, miou, loss_yolo, loss_interframe rtol 5e-3 / atol 1e-5), every
  gradient within 1e-4 of the one-process step's in l2, relative, plus
  1e-5 absolute (the fp32 noise of gradients that are zero in exact
  arithmetic: a bias ahead of a BatchNorm, a softmax's shift), and the
  BatchNorm running statistics equal on both ranks and within 1e-5 of the
  one-process step's. The same negatives on every side (each positive's
  own, so a shard draws what the global batch draws for its rows). The same
  processes then take the step with per-process BatchNorm moments (plain
  DDP: `mesh.bn_group` patched to None), which misses those limits;
- in the same processes, `cli/train.py` over a 7-clip split at a global
  batch of 2 (one clip a rank): both ranks take the 3 steps of the
  one-process run in epoch 0; in epoch 1 only rank 1 is signalled
  (SIGUSR1, after its first step), and both ranks stop after that step,
  checkpoint the epoch and exit;
- `cli/test.py --data_parallel --devices 2` (this process rank 0, one rank
  spawned) gives the one-process run's acc (1e-6) and mIoU (2e-3), with
  --post_process;
- `cli/train.py --devices 2` trains with one checkpoint and one `accu`
  line an epoch; `--devices 1` (a group of one) equals the plain run
  bitwise; `--multihost` runs as one rank of a launch.
"""

import contextlib
import io
import os
import re
import signal
import tempfile

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import dcnet_tpu_torch.cli.common as pcommon
import dcnet_tpu_torch.cli.test as ptest
import dcnet_tpu_torch.cli.train as ptrain
import dcnet_tpu_torch.ops.correspondence as pcorr
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.data.synthetic import generate_synthetic_vid
from dcnet_tpu_torch.data.vid import batch_iterator
from dcnet_tpu_torch.models.darknet import mini_backbone_defs
from dcnet_tpu_torch.models.dcnet import DCNet
from dcnet_tpu_torch.parallel import mesh
from dcnet_tpu_torch.train.state import create_train_state
from dcnet_tpu_torch.train.step import train_step
from dcnet_tpu_torch.weights import seeded_init_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(REPO, "tests", "locks", "converge32tiny.npz")
TRAIN = dict(image_size=64, corpus_size=50, emb_size=64, lstm_hidden=64,
             word_embedding_size=64, jemb_dropout=0.0, input_dropout=0.0)
CLIPS, RANKS = 4, 2
LOSS_RTOL = 1e-3                              # tests/test_train.py:171
METRIC_TOL = dict(rtol=5e-3, atol=1e-5)       # tests/test_train.py:174-177
METRICS = ("acc50", "miou", "loss_yolo", "loss_interframe")
GRAD_REL, GRAD_ABS = 1e-4, 1e-5
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _negatives(generator, pos_idx, num_items, neg_n):
    """Each positive's own negatives: the next neg_n items after it."""
    steps = torch.arange(1, neg_n + 1, device=pos_idx.device)
    return (pos_idx.long()[..., None] + steps) % num_items


def _batch():
    """CLIPS k=2 clips flattened to (2 CLIPS, ...), a phrase a frame."""
    rng = np.random.RandomState(5)
    n = 2 * CLIPS
    ids = rng.randint(1, 50, (n, 20)).astype(np.int64)
    ids[:2, 11:] = 0
    x1, y1 = rng.rand(n) * 30, rng.rand(n) * 30
    box = np.stack([x1, y1, x1 + 4 + rng.rand(n) * 28,
                    y1 + 4 + rng.rand(n) * 28], 1).astype(np.float32)
    return {"images": torch.from_numpy(rng.rand(n, 64, 64, 3).astype(np.float32)),
            "word_ids": torch.from_numpy(ids), "bbox": torch.from_numpy(box)}


def _step(rows=slice(None), ddp=False, per_process_bn=False):
    """One train step of the seeded mini model on `rows` of the batch:
    (metrics, gradients, BatchNorm running statistics)."""
    torch.manual_seed(0)
    model = seeded_init_(DCNet(DCNetConfig(**TRAIN), backbone_defs=mini_backbone_defs(),
                               device="cpu"), seed=0)
    state = create_train_state(model, model.cfg, steps_per_epoch=10)
    if ddp:
        state.ddp = mesh.wrap_ddp(model, CPU)
    batch = {k: v[rows] for k, v in _batch().items()}
    with pytest.MonkeyPatch.context() as m:
        if per_process_bn:  # plain DDP: each process's own moments
            m.setattr(mesh, "bn_group", lambda bn: None)
        metrics = mesh.mean_over_ranks(train_step(state, batch))
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: b.detach().clone() for n, b in model.named_buffers()
             if "running" in n})


STOP_CLIPS = 7                     # an odd split: 9 frames, k=2 windows
STOP_ARGV = ["--synthetic", "--lstm", "--mini", "--size", "64", "--emb_size", "64",
             "--lstm_hidden", "64", "--batch_size", "2", "--nb_epoch", "3",
             "--workers", "0", "--print_freq", "100", "--savename", "stop"]


def _signal_after_first(batches):
    """The batches, with SIGUSR1 sent to this process after the first."""
    it = iter(batches)
    yield next(it)
    os.kill(os.getpid(), signal.SIGUSR1)
    yield from it


def _train_cli(rank: int, split_root: str, out: str) -> dict:
    """`cli/train.py` in this rank of the joined group, rank 1 signalled in
    epoch 1: the step count after each epoch, and the output."""
    real, steps = ptrain.train_epoch, []

    def train_epoch(state, batches, epoch, **kw):
        if rank == 1 and epoch == 1:
            batches = _signal_after_first(batches)
        out = real(state, batches, epoch, **kw)
        steps.append(state.step)
        return out

    os.chdir(out)
    os.environ["DCNET_PLATFORM"] = "cpu"
    ptrain.train_epoch = train_epoch
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        ptrain.main(STOP_ARGV + ["--split_root", split_root])
    return {"steps": steps, "text": text.getvalue(),
            "checkpoints": sorted(os.listdir(os.path.join("saved_models", "stop")))}


def _rank(rank: int, init: str, out: str) -> None:
    """One rank of the spawned pair: its half of the clips, with the
    global-batch BatchNorm and then with per-process moments; then the
    train CLI with one rank signalled."""
    torch.set_num_threads(1)
    pcorr._sample_negatives_excluding = _negatives
    mesh.init_distributed(CPU, RANKS, rank, init)
    try:
        per = 2 * CLIPS // RANKS
        rows = slice(rank * per, (rank + 1) * per)
        res = {"global": _step(rows, ddp=True),
               "per_process": _step(rows, ddp=True, per_process_bn=True),
               "cli": _train_cli(rank, out, out)}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ddp"))
    init = "file://" + os.path.join(out, "store")
    root = os.path.join(out, "synthetic")
    generate_synthetic_vid(root, "train", num_videos=1, frames_per_video=STOP_CLIPS + 2,
                           seed=3, frame_format="npy")
    generate_synthetic_vid(root, "test", num_videos=1, frames_per_video=4, seed=4,
                           frame_format="npy")
    ctx = mp.start_processes(_rank, args=(init, out), nprocs=RANKS, join=False,
                             start_method="spawn")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pcorr, "_sample_negatives_excluding", _negatives)
        one = _step()
    while not ctx.join():
        pass
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(RANKS)]
    return one, ranks


def _within_limits(got: dict, want: dict) -> bool:
    ok = abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    return ok and all(abs(got[k] - want[k]) <= METRIC_TOL["atol"]
                      + METRIC_TOL["rtol"] * abs(want[k]) for k in METRICS)


def _grads_close(got: dict, want: dict) -> list:
    """The parameters whose gradients differ beyond the limits."""
    assert got.keys() == want.keys()
    return [n for n, g in want.items()
            if float((got[n] - g).norm()) > GRAD_REL * float(g.norm()) + GRAD_ABS]


def test_two_process_step_equals_the_global_batch_step(steps):
    (want, grads, _), ranks = steps
    for metrics, got, _ in (r["global"] for r in ranks):
        np.testing.assert_allclose(metrics["loss"], want["loss"], rtol=LOSS_RTOL)
        for k in METRICS:
            np.testing.assert_allclose(metrics[k], want[k], **METRIC_TOL, err_msg=k)
        assert _grads_close(got, grads) == []


def test_running_statistics_move_alike_on_every_rank(steps):
    (_, _, stats), ranks = steps
    first = ranks[0]["global"][2]
    for r in ranks[1:]:
        for n, t in r["global"][2].items():
            assert torch.equal(t, first[n]), n
    for n, t in first.items():
        torch.testing.assert_close(t, stats[n], rtol=1e-5, atol=1e-6, msg=n)


def test_per_process_batch_norm_misses_the_limits(steps):
    """Plain DDP's per-process moments: another step."""
    (want, grads, _), ranks = steps
    assert all(not _within_limits(r["per_process"][0], want) for r in ranks)
    assert all(_grads_close(r["per_process"][1], grads) for r in ranks)
    assert all(_within_limits(r["global"][0], want) for r in ranks)


def test_every_rank_takes_the_steps_of_the_one_process_run(steps):
    """An odd split: 7 // 2 = 3 steps in epoch 0 on both ranks (rows of
    the one-process run's batches of 2)."""
    _, ranks = steps
    assert [r["cli"]["steps"][0] for r in ranks] == [STOP_CLIPS // 2] * RANKS


def test_a_signal_to_one_rank_stops_every_rank_at_one_step(steps):
    """Rank 1 alone is signalled in epoch 1; both stop after its first
    step, checkpoint epoch 1 and exit before epoch 2."""
    _, ranks = steps
    for r in ranks:
        assert "exiting on signal" in r["cli"]["text"]
        assert r["cli"]["steps"] == [STOP_CLIPS // 2, STOP_CLIPS // 2 + 1]
    assert "received signal" in ranks[1]["cli"]["text"]
    assert "received signal" not in ranks[0]["cli"]["text"]
    assert len(re.findall(r"^accu ", ranks[0]["cli"]["text"], re.M)) == 2
    assert ranks[1]["cli"]["checkpoints"] == ["0.pth.tar", "1.pth.tar"]


@pytest.mark.parametrize("n", [7, 8])
def test_batch_slices_partition_the_global_batches(n):
    """Each rank's rows of every global batch of 4, drop_last: as many
    batches on every rank, and together the one-process batches."""
    class Items:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"i": np.asarray([i])}

    want = [b["i"][:, 0] for b in batch_iterator(Items(), 4, shuffle=True, seed=2)]
    got = [[b["i"][:, 0] for b in batch_iterator(Items(), 4, shuffle=True, seed=2,
                                                 batch_shards=2, batch_shard=r)]
           for r in range(2)]
    assert len(got[0]) == len(got[1]) == len(want) == n // 4
    for w, a, b in zip(want, *got):
        assert np.array_equal(np.concatenate([a, b]), w)
    with pytest.raises(ValueError, match="divisible"):
        next(batch_iterator(Items(), 3, batch_shards=2))


def test_global_flip_is_the_identity_pairing_of_one_process():
    x = torch.arange(6.0)[:, None]
    assert torch.equal(mesh.global_flip(x), torch.flip(x, [0]))
    assert mesh.bn_group(torch.nn.BatchNorm1d(2)) is None and mesh.world() == (1, 0)


# --- the CLIs --------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


def _metrics(text, prefix=""):
    for line in reversed(text.strip().splitlines()):
        if line.startswith(prefix) and ("post_process" in line) == bool(prefix):
            return tuple(float(v) for v in line[len(prefix):].strip().split(","))
    raise AssertionError(f"no {prefix!r} metrics line in {text!r}")


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DCNET_PLATFORM", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' thread pools
    return tmp_path


EVAL = ["--synthetic", "--lstm", "--mini", "--size", "64", "--emb_size", "256",
        "--lstm_hidden", "256", "--num_frame_k", "5", "--batch_size", "4",
        "--workers", "0", "--resume", LOCK, "--post_process"]


def test_data_parallel_eval_gives_the_one_process_metrics(workdir):
    _, one = _run(ptest.main, EVAL)
    acc, two = _run(ptest.main, EVAL + ["--data_parallel", "--devices", "2"])
    for prefix in ("", "post_process:"):
        a, b = _metrics(one, prefix), _metrics(two, prefix)
        assert abs(a[0] - b[0]) <= 1e-6 and abs(a[1] - b[1]) <= 2e-3, (prefix, a, b)
    assert acc == pytest.approx(_metrics(two)[0], abs=1e-6)


TRAIN_ARGV = ["--synthetic", "--lstm", "--mini", "--size", "64", "--emb_size", "64",
              "--lstm_hidden", "64", "--batch_size", "4", "--nb_epoch", "1",
              "--max_steps", "1", "--workers", "0"]


def test_train_over_two_processes(workdir):
    state, text = _run(ptrain.main, TRAIN_ARGV + ["--devices", "2", "--savename", "dp"])
    assert len(re.findall(r"^accu ", text, re.M)) == 1
    assert os.listdir("saved_models/dp") == ["0.pth.tar"]
    assert state.step == 1 and mesh.world() == (1, 0)


def test_group_of_one_equals_the_plain_run(workdir):
    plain, _ = _run(ptrain.main, TRAIN_ARGV + ["--savename", "plain"])
    one, _ = _run(ptrain.main, TRAIN_ARGV + ["--devices", "1", "--savename", "one"])
    assert one.ddp is not None and plain.ddp is None
    for (n, a), b in zip(plain.model.state_dict().items(), one.model.state_dict().values()):
        assert torch.equal(a, b), n


def test_multihost_runs_as_a_rank_of_a_launch(workdir, monkeypatch):
    with pytest.raises(ValueError, match="torchrun"):
        ptrain.main(TRAIN_ARGV + ["--multihost"])
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("DCNET_DIST_INIT", "file://" + os.path.join(
        tempfile.mkdtemp(dir=str(workdir)), "store"))
    state, text = _run(ptrain.main, TRAIN_ARGV + ["--multihost", "--savename", "mh"])
    assert state.ddp is not None and os.listdir("saved_models/mh") == ["0.pth.tar"]
    assert mesh.world() == (1, 0)  # the group is gone after the run
    with pytest.raises(ValueError, match="runs one process"):
        pcommon.check_ported(pcommon.base_parser("x").parse_args(["--devices", "2"]))
