"""YOLO → ONNX export (reference ``yolo2onnx.py:268-665``, component Y17).

Walks the :class:`NetworkSpec` emitting Conv/BatchNormalization/LeakyRelu/
Add/Concat/Upsample/MaxPool nodes with NCHW tensors (ONNX convention; our
HWIO weights transpose on the way out). Matching the reference exporter:

- outputs are the RAW pre-yolo feature maps (anchor decode is left to the
  TensorRT-side consumer, yolo2onnx.py:389-396);
- fixed batch 1 at ``onnx_height`` × cfg width (model_cfg yolo_baseline.cfg:4);
- BN epsilon 1e-5, momentum 0.99 (yolo2onnx.py:649-650);
- opset 9 (Upsample-with-scales).
"""

from __future__ import annotations

from typing import List

import numpy as np

from mit_driverless_cv_traininginfra.config.darknet_cfg import (
    ConvBlock,
    MaxPoolBlock,
    NetworkSpec,
    RouteBlock,
    ShortcutBlock,
    UpsampleBlock,
    YoloBlock,
)
from mit_driverless_cv_traininginfra.export import onnx_writer as ox


def export_yolo_onnx(spec: NetworkSpec, params, state, path: str,
                     batch: int = 1, height: int = None, width: int = None) -> str:
    height = height or spec.net.onnx_height
    width = width or spec.net.width

    nodes: List[bytes] = []
    inits: List[bytes] = []
    outputs: List[bytes] = []

    input_name = "000_net"
    tensor_of: List[str] = []  # output tensor name per block
    prev = input_name
    cur_h, cur_w = height, width
    shapes: List = []

    for i, b in enumerate(spec.blocks):
        name = f"{i + 1:03d}_{type(b).__name__.replace('Block', '').lower()}"
        if isinstance(b, ConvBlock):
            p = params[str(i)]
            w_oihw = np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))
            wname = name + "_weights"
            inits.append(ox.make_tensor(wname, w_oihw))
            conv_inputs = [prev, wname]
            conv_out = name + ("_conv" if b.batch_normalize else "")
            if not b.batch_normalize:
                bname = name + "_bias"
                inits.append(ox.make_tensor(bname, np.asarray(p["b"], np.float32)))
                conv_inputs.append(bname)
            pad = (b.size - 1) // 2
            nodes.append(ox.make_node(
                "Conv", conv_inputs, [conv_out], name=name,
                kernel_shape=[b.size, b.size], strides=[b.stride, b.stride],
                pads=[pad, pad, pad, pad], dilations=[1, 1],
            ))
            out = conv_out
            if b.batch_normalize:
                s = state[str(i)]
                bn = p["bn"]
                for suffix, arr in [("_bn_scale", bn["scale"]), ("_bn_bias", bn["bias"]),
                                    ("_bn_mean", s["mean"]), ("_bn_var", s["var"])]:
                    inits.append(ox.make_tensor(name + suffix,
                                                np.asarray(arr, np.float32)))
                bn_out = name + "_bn"
                nodes.append(ox.make_node(
                    "BatchNormalization",
                    [out, name + "_bn_scale", name + "_bn_bias",
                     name + "_bn_mean", name + "_bn_var"],
                    [bn_out], name=name + "_bn", epsilon=1e-5, momentum=0.99,
                ))
                out = bn_out
            if b.activation == "leaky":
                act_out = name + "_lrelu"
                nodes.append(ox.make_node("LeakyRelu", [out], [act_out],
                                          name=name + "_lrelu",
                                          alpha=spec.net.leaky_slope))
                out = act_out
            elif b.activation == "ReLU":
                act_out = name + "_relu"
                nodes.append(ox.make_node("Relu", [out], [act_out],
                                          name=name + "_relu"))
                out = act_out
            cur_h, cur_w = cur_h // b.stride, cur_w // b.stride
        elif isinstance(b, MaxPoolBlock):
            out = name
            pad = (b.size - 1) // 2
            if b.size == 2 and b.stride == 1:
                # the trained graph ZERO-pads right/bottom before this pool
                # (models.py:74-84 / darknet._maxpool); ONNX MaxPool pads
                # with -inf, so emit an explicit constant-0 Pad node to keep
                # the exported artifact numerically identical at the edges
                pad_out = name + "_zeropad"
                nodes.append(ox.make_node(
                    "Pad", [prev], [pad_out], name=pad_out, mode="constant",
                    pads=[0, 0, 0, 0, 0, 0, 1, 1], value=0.0))
                nodes.append(ox.make_node("MaxPool", [pad_out], [out],
                                          name=name, kernel_shape=[2, 2],
                                          strides=[1, 1], pads=[0, 0, 0, 0]))
            else:
                nodes.append(ox.make_node("MaxPool", [prev], [out], name=name,
                                          kernel_shape=[b.size, b.size],
                                          strides=[b.stride, b.stride],
                                          pads=[pad, pad, pad, pad]))
            cur_h, cur_w = cur_h // b.stride, cur_w // b.stride
        elif isinstance(b, UpsampleBlock):
            out = name
            sname = name + "_scales"
            inits.append(ox.make_tensor(
                sname, np.asarray([1.0, 1.0, float(b.stride), float(b.stride)],
                                  np.float32)))
            nodes.append(ox.make_node("Upsample", [prev, sname], [out],
                                      name=name, mode="nearest"))
            cur_h, cur_w = cur_h * b.stride, cur_w * b.stride
        elif isinstance(b, RouteBlock):
            srcs = [tensor_of[li] for li in b.layers]
            if len(srcs) == 1:
                out = srcs[0]  # pure re-route, no node needed
                cur_h, cur_w = shapes[b.layers[0]]
            else:
                out = name
                nodes.append(ox.make_node("Concat", srcs, [out], name=name, axis=1))
                cur_h, cur_w = shapes[b.layers[0]]
        elif isinstance(b, ShortcutBlock):
            out = name
            nodes.append(ox.make_node("Add", [tensor_of[-1], tensor_of[b.from_layer]],
                                      [out], name=name))
        elif isinstance(b, YoloBlock):
            out = prev  # head output = previous conv's raw map
            outputs.append(ox.make_value_info(
                out, [batch, (spec.net.num_classes + 5) * len(b.mask),
                      cur_h, cur_w]))
        tensor_of.append(out)
        shapes.append((cur_h, cur_w))
        prev = out

    graph = ox.make_graph(
        "yolo", nodes,
        inputs=[ox.make_value_info(input_name,
                                   [batch, spec.net.channels, height, width])],
        outputs=outputs, initializers=inits,
    )
    model = ox.make_model(graph, opset=9)
    ox.save_model(path, model)
    return path
