import os

import pytest

from mit_driverless_cv_traininginfra.config import (
    VANILLA_ANCHORS,
    load_network_spec,
    parse_model_config,
)
from mit_driverless_cv_traininginfra.config.darknet_cfg import (
    ConvBlock,
    MaxPoolBlock,
    RouteBlock,
    ShortcutBlock,
    UpsampleBlock,
    YoloBlock,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")


def test_parse_model_config_blocks():
    defs = parse_model_config(FIXTURE)
    assert defs[0]["type"] == "net"
    assert defs[1]["type"] == "convolutional"
    # convolutional blocks get default batch_normalize=0 (parse_config.py:12-13)
    assert defs[1]["batch_normalize"] == "0"
    types = [d["type"] for d in defs[1:]]
    assert types.count("yolo") == 2


def test_load_network_spec_structure():
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    assert spec.net.width == 64 and spec.net.num_classes == 1
    assert spec.anchors == VANILLA_ANCHORS
    kinds = [type(b) for b in spec.blocks]
    assert kinds.count(YoloBlock) == 2
    assert ShortcutBlock in kinds and RouteBlock in kinds
    assert UpsampleBlock in kinds and MaxPoolBlock in kinds

    # preyolo conv: width (classes+5)*len(mask)=18, no BN, linear activation
    preyolo = [b for b in spec.blocks if isinstance(b, ConvBlock) and b.is_preyolo]
    assert len(preyolo) == 2
    assert all(b.filters == 18 and not b.batch_normalize for b in preyolo)
    assert all(b.activation == "linear" for b in preyolo)

    # yolo heads pick masked anchors out of the 9-anchor list
    heads = [b for b in spec.blocks if isinstance(b, YoloBlock)]
    assert heads[0].anchors == tuple(VANILLA_ANCHORS[i] for i in (3, 4, 5))
    assert heads[1].anchors == tuple(VANILLA_ANCHORS[i] for i in (0, 1, 2))


def test_out_channels_route_and_shortcut():
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    chans = spec.out_channels
    # chans[0] is the input (3); conv blocks produce their filter count
    assert chans[0] == 3 and chans[1] == 8
    blocks = spec.blocks
    # shortcut copies channels from its source (models.py:99-100)
    i_short = next(i for i, b in enumerate(blocks) if isinstance(b, ShortcutBlock))
    assert chans[i_short + 1] == chans[i_short + 1 + blocks[i_short].from_layer]
    # two-way route concatenates: layers=-1,4 → chans[-1 rel] + block4 output
    i_route2 = max(i for i, b in enumerate(blocks) if isinstance(b, RouteBlock))
    r = blocks[i_route2]
    assert len(r.layers) == 2
    expected = chans[i_route2] + chans[r.layers[1] + 1]
    assert chans[i_route2 + 1] == expected


def test_anchors_override():
    anchors = [(float(i), float(i + 1)) for i in range(9)]
    spec = load_network_spec(FIXTURE, anchors_override=anchors)
    assert spec.anchors == tuple(tuple(a) for a in anchors)


def test_missing_cfg_raises():
    with pytest.raises(FileNotFoundError):
        load_network_spec("/nonexistent.cfg")
