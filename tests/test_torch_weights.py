"""The port's weight bridges: `state_dict_from_jax` against the JAX
package's own exporter, strict loading into the port model, and the Darknet
`.weights` reader/writer against the JAX package's on the full YOLOv3
layer list."""

import numpy as np
import pytest
import torch

import dcnet_tpu.models.darknet as jdk
from dcnet_tpu.train.checkpoint import export_reference_state_dict
import dcnet_tpu_torch.models.darknet as pdk
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.models.dcnet import DCNet
from dcnet_tpu_torch.weights import (
    load_into, seeded_init_, splice_darknet_weights, state_dict_from_jax)
from tests.test_torch_slice import SMALL, jax_model


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[False, True], ids=["full", "light"])
def exported(request):
    light = request.param
    _, _, variables = jax_model(light=light, seed=5)
    ref = export_reference_state_dict(variables["params"],
                                      variables["batch_stats"], light=light)
    ours = state_dict_from_jax(variables["params"], variables["batch_stats"],
                               light=light)
    return light, ref, ours


def test_state_dict_from_jax_equals_export(exported):
    _, ref, ours = exported
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)


def test_state_dict_loads_strict_into_port(exported):
    light, _, ours = exported
    model = DCNet(DCNetConfig(**SMALL, light=light),
                  backbone_defs=pdk.mini_backbone_defs(), device="cpu")
    load_into(model, ours)  # strict=True: no missing, no unexpected key
    own = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert own == set(ours)
    for k, v in ours.items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v, err_msg=k)


def test_reference_style_state_dict_loads(exported):
    """A reference `.pth.tar` state_dict (torch tensors, DDP `module.`
    prefix, num_batches_tracked present) loads as it is."""
    light, _, ours = exported
    sd = {f"module.{k}": torch.from_numpy(v.copy()) for k, v in ours.items()}
    model = DCNet(DCNetConfig(**SMALL, light=light),
                  backbone_defs=pdk.mini_backbone_defs(), device="cpu")
    for k in model.state_dict():
        if k.endswith("num_batches_tracked"):
            sd[f"module.{k}"] = torch.tensor(7)
    load_into(model, sd)
    assert int(model.state_dict()["corr_conv.0.0.bn.num_batches_tracked"]) == 7


def test_yolov3_weights_readers_agree_and_load_strict(tmp_path):
    """One random `.weights` file for the full YOLOv3 list: both writers
    give the same bytes, both readers the same arrays, and the file loads
    strictly into the full-width port model."""
    jdefs, pdefs = jdk.yolov3_layer_defs(), pdk.yolov3_layer_defs()
    path, jpath = str(tmp_path / "yolo.weights"), str(tmp_path / "jax.weights")
    pdk.random_darknet_weights_file(pdefs, path, seed=3)
    jdk.random_darknet_weights_file(jdefs, jpath, seed=3)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    jvars, jheader = jdk.load_darknet_weights(jdefs, path)
    sd, header = pdk.load_darknet_weights(pdefs, path)
    np.testing.assert_array_equal(header, jheader)
    want = state_dict_from_jax({"visumodel": jvars["params"]},
                               {"visumodel": jvars["batch_stats"]})
    assert set(sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)

    model = DCNet(DCNetConfig(image_size=256, corpus_size=100), device="cpu")
    splice_darknet_weights(model, path)  # strict load of the whole model
    conv = model.visumodel.module_list[0].conv_0.weight
    np.testing.assert_array_equal(
        conv.detach().numpy(), sd["visumodel.module_list.0.conv_0.weight"])


def test_darknet_writer_roundtrip(tmp_path):
    defs = pdk.mini_backbone_defs()
    a, b = str(tmp_path / "a.weights"), str(tmp_path / "b.weights")
    pdk.random_darknet_weights_file(defs, a, seed=4)
    sd, header = pdk.load_darknet_weights(defs, a)
    pdk.save_darknet_weights(defs, sd, b, header=header)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


def test_seeded_init_is_deterministic():
    cfg = DCNetConfig(**SMALL)
    m1 = seeded_init_(DCNet(cfg, backbone_defs=pdk.mini_backbone_defs(),
                            device="cpu"), seed=9)
    m2 = seeded_init_(DCNet(cfg, backbone_defs=pdk.mini_backbone_defs(),
                            device="cpu"), seed=9)
    for (k, v), w in zip(m1.state_dict().items(), m2.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
