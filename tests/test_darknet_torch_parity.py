"""Full-graph parity: our spec-driven NHWC executor vs a torch NCHW oracle
built independently from the same cfg, sharing weights via the Darknet
.weights byte format (so this also exercises the weight IO both ways)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.config.darknet_cfg import (
    ConvBlock,
    MaxPoolBlock,
    RouteBlock,
    ShortcutBlock,
    UpsampleBlock,
    YoloBlock,
)
from mit_driverless_cv_traininginfra.models.darknet import (
    decode_head,
    forward_features,
    init_params,
    save_darknet_weights,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")


@pytest.mark.parity
def test_forward_matches_torch_oracle(tmp_path):
    torch = pytest.importorskip("torch")
    nn, F = torch.nn, torch.nn.functional

    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    # randomise BN stats so eval-BN is non-trivial
    state = jax.tree_util.tree_map(
        lambda x: x + jax.random.uniform(jax.random.PRNGKey(1), x.shape) * 0.2,
        state,
    )
    wpath = str(tmp_path / "w.weights")
    save_darknet_weights(spec, params, state, wpath)

    # --- torch oracle: module list driven by the same spec --------------
    chans = spec.out_channels
    modules = []
    for i, b in enumerate(spec.blocks):
        if isinstance(b, ConvBlock):
            conv = nn.Conv2d(chans[i], b.filters, b.size, b.stride,
                             (b.size - 1) // 2, bias=not b.batch_normalize)
            bn = nn.BatchNorm2d(b.filters) if b.batch_normalize else None
            modules.append(("conv", conv, bn, b))
        else:
            modules.append((type(b).__name__, None, None, b))

    # stream the .weights file into the torch modules (Darknet order)
    with open(wpath, "rb") as fp:
        np.fromfile(fp, dtype=np.int32, count=5)
        weights = np.fromfile(fp, dtype=np.float32)
    ptr = 0
    for kind, conv, bn, b in modules:
        if kind != "conv":
            continue
        cout = b.filters
        if bn is not None:
            for t in (bn.bias, bn.weight, bn.running_mean, bn.running_var):
                t.data.copy_(torch.from_numpy(weights[ptr:ptr + cout])); ptr += cout
        else:
            conv.bias.data.copy_(torch.from_numpy(weights[ptr:ptr + cout])); ptr += cout
        n = conv.weight.numel()
        conv.weight.data.copy_(
            torch.from_numpy(weights[ptr:ptr + n]).view_as(conv.weight)); ptr += n
    assert ptr == len(weights)

    def torch_forward(x):
        outs, layer_outputs = [], []
        for kind, conv, bn, b in modules:
            if kind == "conv":
                x = conv(x)
                if bn is not None:
                    bn.eval()
                    x = bn(x)
                if b.activation == "leaky":
                    x = F.leaky_relu(x, spec.net.leaky_slope)
            elif kind == "MaxPoolBlock":
                if b.size == 2 and b.stride == 1:
                    x = F.max_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1)
                else:
                    x = F.max_pool2d(x, b.size, b.stride, (b.size - 1) // 2)
            elif kind == "UpsampleBlock":
                x = F.interpolate(x, scale_factor=b.stride, mode="nearest")
            elif kind == "RouteBlock":
                x = torch.cat([layer_outputs[li] for li in b.layers], 1)
            elif kind == "ShortcutBlock":
                x = layer_outputs[-1] + layer_outputs[b.from_layer]
            elif kind == "YoloBlock":
                outs.append(x)
            layer_outputs.append(x)
        return outs

    x = np.random.default_rng(2).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        ref_heads = torch_forward(torch.from_numpy(x))

    heads, _ = forward_features(spec, params, state,
                                jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert len(heads) == len(ref_heads)
    for ours, theirs in zip(heads, ref_heads):
        np.testing.assert_allclose(
            np.asarray(jnp.transpose(ours, (0, 3, 1, 2))),
            theirs.numpy(), atol=2e-4,
        )

    # decode parity: sigmoid/exp/grid arithmetic vs a direct restatement
    h0 = np.asarray(jnp.transpose(heads[0], (0, 3, 1, 2)))  # (B, 18, H, W)
    anchors = spec.blocks[
        [i for i, b in enumerate(spec.blocks) if isinstance(b, YoloBlock)][0]
    ].anchors
    dec = decode_head(heads[0], anchors, spec.net.height, spec.net.num_classes)
    B, _, gh, gw = h0.shape
    stride = spec.net.height / gh
    pred = h0.reshape(B, 3, 6, gh, gw).transpose(0, 1, 3, 4, 2)
    sig = lambda v: 1 / (1 + np.exp(-v))
    gx, gy = np.meshgrid(np.arange(gw), np.arange(gh))
    exp_cx = (sig(pred[..., 0]) + gx) * stride
    np.testing.assert_allclose(
        np.asarray(dec[..., 0]).reshape(B, 3, gh, gw), exp_cx, atol=2e-4)
    aw = np.asarray([a[0] for a in anchors])[None, :, None, None] / stride
    exp_w = np.exp(pred[..., 2]) * aw * stride
    np.testing.assert_allclose(
        np.asarray(dec[..., 2]).reshape(B, 3, gh, gw), exp_w, rtol=2e-4)
