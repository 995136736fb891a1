"""The port's training CLI (`python -m dcnet_tpu_torch.cli.train`) on the
CPU (`DCNET_PLATFORM=cpu`), in-process, over the synthetic train split
(augmented) at mini defs, 64 px and small widths, with the BiLSTM and with
bert-mini: it trains, validates, prints `accu ... miou ...`, writes a
checkpoint every epoch, and `cli.test --resume` reads the checkpoint
directory. A run resumed after epoch 0 ends bitwise where the
uninterrupted two-epoch run ends, `--profile_dir` in the first epoch
included (it writes its trace and leaves the run as it was). More than one
process or card raises."""

import contextlib
import io
import os
import re

import pytest
import torch

import dcnet_tpu_torch.cli.test as ptest
import dcnet_tpu_torch.cli.train as ptrain

SMALL = ["--synthetic", "--mini", "--size", "64", "--batch_size", "2",
         "--max_steps", "2", "--workers", "0", "--emb_size", "64",
         "--lstm_hidden", "64", "--print_freq", "1"]
ENCODERS = {"lstm": ["--lstm"], "bert": ["--bert_model", "bert-mini"]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DCNET_PLATFORM", "cpu")
    return tmp_path


def _weights(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_train_resume_profile_and_eval(workdir):
    """The BiLSTM: two epochs; one epoch with `--profile_dir` (whose trace
    is written and whose steps leave no mark), resumed to two, ends bitwise
    where the two-epoch run ends; `cli.test` reads the checkpoints."""
    base = SMALL + ENCODERS["lstm"]
    full, text = _run(ptrain.main, base + ["--nb_epoch", "2", "--savename", "full"])
    lines = re.findall(r"^accu (\S+) miou (\S+)$", text, re.M)
    assert len(lines) == 2 and len(re.findall(r"^Epoch \[1\]\[1\] loss", text, re.M)) == 1
    assert "Num of parameters:" in text
    assert sorted(os.listdir("saved_models/full")) == ["0.pth.tar", "1.pth.tar"]
    assert full.step == 4

    _, text = _run(ptrain.main, base + ["--nb_epoch", "1", "--savename", "half",
                                        "--profile_dir", "prof"])
    assert os.path.getsize("prof/train_steps.json") > 0 and "wrote a trace" in text
    resumed, text = _run(ptrain.main, base + ["--nb_epoch", "2", "--savename", "half",
                                              "--resume", "saved_models/half"])
    assert "resumed from saved_models/half at epoch 1" in text
    assert len(re.findall(r"^accu ", text, re.M)) == 1
    a, b = _weights(full), _weights(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert resumed.step == full.step

    acc, text = _run(ptest.main, base + ["--num_frame_k", "5", "--resume",
                                         "saved_models/full", "--savename", "t"])
    got = [float(x) for x in text.strip().splitlines()[-1].split(",")]
    assert got[0] == acc and 0.0 <= got[1] <= 1.0


def test_train_and_eval_with_bert(workdir):
    """bert-mini: an epoch (its checkpoint), `--auto_resume` continuing
    from it, and `cli.test` on the checkpoint directory."""
    base = SMALL + ENCODERS["bert"] + ["--savename", "bert"]
    state, text = _run(ptrain.main, base + ["--nb_epoch", "1"])
    assert len(re.findall(r"^accu ", text, re.M)) == 1 and state.step == 2
    assert os.listdir("saved_models/bert") == ["0.pth.tar"]
    assert all(not p.requires_grad for n, p in state.model.named_parameters()
               if n.startswith("textmodel.") and not n.startswith("textmodel.proj."))
    _, text = _run(ptrain.main, base + ["--nb_epoch", "1", "--auto_resume"])
    assert "auto-resumed from saved_models/bert at epoch 1" in text
    assert not re.findall(r"^accu ", text, re.M)  # nothing left to train
    acc, text = _run(ptest.main, SMALL + ENCODERS["bert"] + [
        "--num_frame_k", "5", "--resume", "saved_models/bert", "--savename", "t"])
    got = [float(x) for x in text.strip().splitlines()[-1].split(",")]
    assert got[0] == acc and 0.0 <= got[1] <= 1.0


@pytest.mark.parametrize("argv", [["--multihost"], ["--devices", "2"]])
def test_more_than_one_process_or_card_raises(workdir, argv, monkeypatch):
    """More than one process runs (tests/test_torch_parallel.py); these
    options raise only where their processes cannot start: --multihost
    outside torchrun's launch, --devices above the cards there are."""
    monkeypatch.setattr(ptrain, "cli_device", lambda: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    match = "torchrun" if argv == ["--multihost"] else "--devices 2: 1 CUDA devices"
    with pytest.raises(ValueError, match=match):
        ptrain.main(SMALL + ENCODERS["lstm"] + argv)
