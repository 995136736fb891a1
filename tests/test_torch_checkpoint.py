"""The port's checkpoints (`dcnet_tpu_torch/train/checkpoint.py`) on the
CPU: save and restore round trips (weights, statistics, optimizer,
schedule, step), pruning to the latest `keep`, `load_pretrain`'s
name-and-shape intersection, and an orbax checkpoint written by the JAX
package's `save_checkpoint`, which the port does not read itself: restored
with the JAX package and carried across with `state_dict_from_jax`, it
loads into the port as the weights it was written from."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcnet_tpu_torch.cli.common as pcommon
from dcnet_tpu.config import DCNetConfig as JaxConfig
from dcnet_tpu.models import DCNet as JaxDCNet
from dcnet_tpu.models.darknet import mini_backbone_defs as jax_mini_defs
from dcnet_tpu.train import checkpoint as jckpt
from dcnet_tpu.train.state import create_train_state as jax_create_train_state
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.models.darknet import mini_backbone_defs
from dcnet_tpu_torch.models.dcnet import DCNet
from dcnet_tpu_torch.train import checkpoint as ckpt
from dcnet_tpu_torch.train.state import create_train_state
from dcnet_tpu_torch.train.step import train_step
from dcnet_tpu_torch.weights import load_into, seeded_init_, state_dict_from_jax
from tests.test_torch_bert import filled_variables
from tests.test_torch_slice import SMALL
from tests.test_torch_train import _batch


def _state(seed=0, **over):
    cfg = DCNetConfig(**{**SMALL, **over})
    model = seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(), device="cpu"),
                         seed=seed)
    return create_train_state(model, cfg, steps_per_epoch=2)


def _stepped(seed=0, steps=2):
    state = _state(seed)
    batch = {n: torch.from_numpy(v) for n, v in _batch(2).items()}
    for _ in range(steps):
        train_step(state, batch, torch.Generator().manual_seed(0))
    return state


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(ob["state"][i][k])), (i, k)
    assert a.step == b.step and a.schedule.state_dict() == b.schedule.state_dict()


def test_save_restore_round_trip(tmp_path):
    state = _stepped()
    path = ckpt.save_checkpoint(str(tmp_path), state, epoch=4, best_acc=0.25)
    assert os.path.basename(path) == "4.pth.tar"
    blob = torch.load(path, weights_only=False)
    assert {"epoch", "state_dict", "best_loss", "optimizer"} <= set(blob)  # the reference's
    fresh = _state(seed=9)
    fresh, next_epoch, best = ckpt.restore_checkpoint(str(tmp_path), fresh)
    assert (next_epoch, best) == (5, 0.25)
    _same_state(state, fresh)
    # weights only: the optimizer keeps its own (empty) state
    other = _state(seed=9)
    other, _, _ = ckpt.restore_checkpoint(str(tmp_path), other, with_opt_state=False)
    assert other.step == 0 and not other.optimizer.state_dict()["state"]
    for k, v in state.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v)


def test_keep_prunes_and_restores_the_latest(tmp_path):
    state = _state()
    for epoch in range(5):
        state.step = epoch
        ckpt.save_checkpoint(str(tmp_path), state, epoch, best_acc=epoch / 10, keep=3)
    assert ckpt.checkpoint_epochs(str(tmp_path)) == [2, 3, 4]
    assert sorted(os.listdir(tmp_path)) == ["2.pth.tar", "3.pth.tar", "4.pth.tar"]
    _, next_epoch, best = ckpt.restore_checkpoint(str(tmp_path), _state())
    assert (next_epoch, best) == (5, 0.4)
    _, next_epoch, _ = ckpt.restore_checkpoint(str(tmp_path), _state(), epoch=2)
    assert next_epoch == 3
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), _state())


def test_load_pretrain_takes_the_shared_parameters(tmp_path):
    """Keys and shapes the model shares load; the rest (here the word
    embedding of a larger corpus) keep the model's own values; no shared
    key raises."""
    src = _stepped()
    ckpt.save_checkpoint(str(tmp_path), src, 0, 0.0)
    dst = _state(seed=5, corpus_size=60)
    before = {k: v.clone() for k, v in dst.model.state_dict().items()}
    ckpt.load_pretrain(str(tmp_path), dst)
    after, want = dst.model.state_dict(), src.model.state_dict()
    for k in after:
        shared = after[k].shape == want[k].shape
        assert torch.equal(after[k], want[k] if shared else before[k]), k
    assert after["textmodel.embedding.weight"].shape != want["textmodel.embedding.weight"].shape
    torch.save({"state_dict": {"nothing": torch.zeros(1)}}, tmp_path / "x.pth.tar")
    with pytest.raises(ValueError, match="shares no parameters"):
        ckpt.load_pretrain(str(tmp_path / "x.pth.tar"), dst)


def test_reference_export_loads_back(tmp_path):
    """`export_reference_state_dict` in the reference's wrapper loads
    through `load_reference_checkpoint` (strict) as the same weights, and a
    key the model lacks raises in strict mode."""
    src = _stepped()
    sd = ckpt.export_reference_state_dict(src.model)
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"epoch": 3, "state_dict": sd, "best_loss": 0.0, "optimizer": {}}, path)
    dst = _state(seed=7)
    report = ckpt.load_reference_checkpoint(path, dst.model)
    assert not report.unmatched and not report.untouched and len(report.matched) == len(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(dst.model.state_dict()[k].numpy(), v, err_msg=k)
    sd["extra.weight"] = np.zeros(1, np.float32)
    torch.save(sd, path)
    with pytest.raises(KeyError, match="no mapping"):
        ckpt.load_reference_checkpoint(path, dst.model)


def test_orbax_checkpoint_carried_across_through_jax(tmp_path):
    """The JAX package writes an orbax checkpoint; restored there and
    carried across, it loads into the port as the trees it was written
    from. The port's own reader refuses the directory by name."""
    jcfg = JaxConfig(**SMALL)
    jmodel = JaxDCNet(cfg=jcfg, backbone_defs=jax_mini_defs())
    b = _batch(2, seed=0)
    variables = jax.tree_util.tree_map(jnp.asarray, filled_variables(
        jmodel, jnp.asarray(b["images"]), jnp.asarray(b["word_ids"]), seed=3))
    state = jax_create_train_state(jmodel, jcfg, jax.random.PRNGKey(3),
                                   steps_per_epoch=2, variables=variables)
    ckdir = str(tmp_path / "orbax")
    jckpt.save_checkpoint(ckdir, state, epoch=1, best_acc=0.5)
    template = state.replace(params=jax.tree_util.tree_map(jnp.zeros_like, state.params))
    restored, next_epoch, best = jckpt.restore_checkpoint(ckdir, template,
                                                          with_opt_state=False)
    assert (next_epoch, best) == (2, 0.5)
    sd = state_dict_from_jax(jax.device_get(restored.params),
                             jax.device_get(restored.batch_stats))
    port = _state().model
    load_into(port, sd)
    want = state_dict_from_jax(jax.device_get(state.params),
                               jax.device_get(state.batch_stats))
    for k, v in want.items():
        np.testing.assert_array_equal(port.state_dict()[k].numpy(), v, err_msg=k)
    with pytest.raises(NotImplementedError, match="orbax.*state_dict_from_jax"):
        pcommon.restore_weights(ckdir, port)
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.restore_checkpoint(ckdir, _state())
