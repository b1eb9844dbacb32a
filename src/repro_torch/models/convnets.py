"""Tensor-size graph builders for the paper's six evaluation networks.

The planner needs only op ordering + intermediate tensor SHAPES, so each
builder reconstructs the network as a ``Graph`` from the published
architecture spec (fp32, NHWC, 64-byte alignment — the paper's setting).

Fidelity validation: the paper's *Naive* and *Lower Bound* rows are
strategy-independent functions of the graph, so matching them means the
reconstruction is faithful (benchmarks/table*.py prints our values next
to the paper's). MobileNet v1/v2 and Inception v3 follow their papers
exactly; DeepLab v3 (MobileNetV2-OS16 + ASPP head, 257²), PoseNet
(MobileNetV1-101 backbone + 4 heads, 257²) and BlazeFace (128²,
5×5 dw BlazeBlocks) are reconstructed from the cited papers/TFLite model
cards — deviations show up directly in the Naive/LB comparison and are
discussed in EXPERIMENTS.md.
"""

from __future__ import annotations

import math

from repro_torch.core.graph import Graph, GraphBuilder


def _conv_out(size: int, stride: int) -> int:
    """TF 'SAME' padding output size."""
    return -(-size // stride)


def mobilenet_v1(input_size: int = 224, alpha: float = 1.0,
                 name: str = "mobilenet_v1") -> Graph:
    g = GraphBuilder(name)
    s = input_size
    x = g.input((1, s, s, 3))
    s = _conv_out(s, 2)
    c = int(32 * alpha)
    x = g.op("conv3x3_s2", [x], (1, s, s, c))
    # 13 depthwise-separable blocks: (out_channels, stride)
    blocks = [
        (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
        (1024, 1),
    ]
    for out_c, stride in blocks:
        out_c = int(out_c * alpha)
        s2 = _conv_out(s, stride)
        x = g.op("dw3x3", [x], (1, s2, s2, c))
        s = s2
        x = g.op("pw1x1", [x], (1, s, s, out_c))
        c = out_c
    x = g.op("avgpool", [x], (1, 1, 1, c))
    logits = g.op("fc", [x], (1, 1001))
    g.mark_output(logits)
    return g.build()


def mobilenet_v2(input_size: int = 224, name: str = "mobilenet_v2") -> Graph:
    g = GraphBuilder(name)
    s = input_size
    x = g.input((1, s, s, 3))
    s = _conv_out(s, 2)
    x = g.op("conv3x3_s2", [x], (1, s, s, 32))
    c = 32

    def bottleneck(x, c_in, c_out, stride, t, s_in, dilation=1):
        nonlocal g
        s_out = _conv_out(s_in, stride)
        h = x
        exp = c_in * t
        if t != 1:
            h = g.op("expand1x1", [h], (1, s_in, s_in, exp))
        h = g.op("dw3x3", [h], (1, s_out, s_out, exp))
        h = g.op("project1x1", [h], (1, s_out, s_out, c_out))
        if stride == 1 and c_in == c_out:
            h = g.op("add", [x, h], (1, s_out, s_out, c_out))
        return h, s_out

    # (t, c, n, s)
    cfg = [
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    ]
    for t, c_out, n, stride in cfg:
        for i in range(n):
            x, s = bottleneck(x, c, c_out, stride if i == 0 else 1, t, s)
            c = c_out
    x = g.op("conv1x1_1280", [x], (1, s, s, 1280))
    x = g.op("avgpool", [x], (1, 1, 1, 1280))
    logits = g.op("fc", [x], (1, 1001))
    g.mark_output(logits)
    return g.build()


def inception_v3(input_size: int = 299, name: str = "inception_v3") -> Graph:
    g = GraphBuilder(name)
    s = input_size
    x = g.input((1, s, s, 3))
    # stem (VALID padding like TF slim)
    s = (s - 3) // 2 + 1  # 149
    x = g.op("conv3x3_s2", [x], (1, s, s, 32))
    s = s - 2  # 147
    x = g.op("conv3x3", [x], (1, s, s, 32))
    x = g.op("conv3x3_pad", [x], (1, s, s, 64))
    s = (s - 3) // 2 + 1  # 73
    x = g.op("maxpool", [x], (1, s, s, 64))
    x = g.op("conv1x1", [x], (1, s, s, 80))
    s = s - 2  # 71
    x = g.op("conv3x3", [x], (1, s, s, 192))
    s = (s - 3) // 2 + 1  # 35
    x = g.op("maxpool", [x], (1, s, s, 192))

    def branch(x, s, chans, name_prefix):
        h = x
        for i, (c, _) in enumerate(chans):
            h = g.op(f"{name_prefix}_{i}", [h], (1, s, s, c))
        return h

    def inception_a(x, s, pool_c):
        b0 = branch(x, s, [(64, 1)], "a_b0")
        b1 = branch(x, s, [(48, 1), (64, 5)], "a_b1")
        b2 = branch(x, s, [(64, 1), (96, 3), (96, 3)], "a_b2")
        p = g.op("a_pool", [x], (1, s, s, x_c[0]))
        b3 = g.op("a_poolproj", [p], (1, s, s, pool_c))
        out_c = 64 + 64 + 96 + pool_c
        return g.op("a_concat", [b0, b1, b2, b3], (1, s, s, out_c)), out_c

    x_c = [192]
    x, c = inception_a(x, s, 32); x_c = [c]
    x, c = inception_a(x, s, 64); x_c = [c]
    x, c = inception_a(x, s, 64); x_c = [c]

    # reduction A: 35 -> 17
    s2 = (s - 3) // 2 + 1  # 17
    b0 = g.op("ra_b0", [x], (1, s2, s2, 384))
    h = g.op("ra_b1_0", [x], (1, s, s, 64))
    h = g.op("ra_b1_1", [h], (1, s, s, 96))
    b1 = g.op("ra_b1_2", [h], (1, s2, s2, 96))
    b2 = g.op("ra_pool", [x], (1, s2, s2, c))
    x = g.op("ra_concat", [b0, b1, b2], (1, s2, s2, 384 + 96 + c))
    s, c = s2, 384 + 96 + c  # 768

    def inception_b(x, s, c7):
        b0 = branch(x, s, [(192, 1)], "b_b0")
        b1 = branch(x, s, [(c7, 1), (c7, 7), (192, 7)], "b_b1")
        b2 = branch(x, s, [(c7, 1), (c7, 7), (c7, 7), (c7, 7), (192, 7)], "b_b2")
        p = g.op("b_pool", [x], (1, s, s, c))
        b3 = g.op("b_poolproj", [p], (1, s, s, 192))
        return g.op("b_concat", [b0, b1, b2, b3], (1, s, s, 768))

    for c7 in (128, 160, 160, 192):
        x = inception_b(x, s, c7)

    # reduction B: 17 -> 8
    s2 = (s - 3) // 2 + 1  # 8
    h = g.op("rb_b0_0", [x], (1, s, s, 192))
    b0 = g.op("rb_b0_1", [h], (1, s2, s2, 320))
    h = g.op("rb_b1_0", [x], (1, s, s, 192))
    h = g.op("rb_b1_1", [h], (1, s, s, 192))
    h = g.op("rb_b1_2", [h], (1, s, s, 192))
    b1 = g.op("rb_b1_3", [h], (1, s2, s2, 192))
    b2 = g.op("rb_pool", [x], (1, s2, s2, 768))
    x = g.op("rb_concat", [b0, b1, b2], (1, s2, s2, 1280))
    s, c = s2, 1280

    def inception_c(x, s, c_in):
        b0 = branch(x, s, [(320, 1)], "c_b0")
        h = g.op("c_b1_0", [x], (1, s, s, 384))
        b1a = g.op("c_b1_1a", [h], (1, s, s, 384))
        b1b = g.op("c_b1_1b", [h], (1, s, s, 384))
        b1 = g.op("c_b1_cat", [b1a, b1b], (1, s, s, 768))
        h = g.op("c_b2_0", [x], (1, s, s, 448))
        h = g.op("c_b2_1", [h], (1, s, s, 384))
        b2a = g.op("c_b2_2a", [h], (1, s, s, 384))
        b2b = g.op("c_b2_2b", [h], (1, s, s, 384))
        b2 = g.op("c_b2_cat", [b2a, b2b], (1, s, s, 768))
        p = g.op("c_pool", [x], (1, s, s, c_in))
        b3 = g.op("c_poolproj", [p], (1, s, s, 192))
        return g.op("c_concat", [b0, b1, b2, b3], (1, s, s, 2048))

    x = inception_c(x, s, 1280)
    x = inception_c(x, s, 2048)
    x = g.op("avgpool", [x], (1, 1, 1, 2048))
    logits = g.op("fc", [x], (1, 1001))
    g.mark_output(logits)
    return g.build()


def deeplab_v3(input_size: int = 257, name: str = "deeplab_v3") -> Graph:
    """DeepLab v3 with MobileNetV2 backbone at output-stride 16 + ASPP
    (the TFLite mobile segmentation model, 257×257, 21 classes)."""
    g = GraphBuilder(name)
    s = input_size
    x = g.input((1, s, s, 3))
    s = _conv_out(s, 2)  # 129
    x = g.op("conv3x3_s2", [x], (1, s, s, 32))
    c = 32

    def bottleneck(x, c_in, c_out, stride, t, s_in):
        s_out = _conv_out(s_in, stride)
        h = x
        exp = c_in * t
        if t != 1:
            h = g.op("expand1x1", [h], (1, s_in, s_in, exp))
        h = g.op("dw3x3", [h], (1, s_out, s_out, exp))
        h = g.op("project1x1", [h], (1, s_out, s_out, c_out))
        if stride == 1 and c_in == c_out:
            h = g.op("add", [x, h], (1, s_out, s_out, c_out))
        return h, s_out

    # OS16: the final stride-2 stage becomes stride-1 (atrous)
    cfg = [
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 1), (6, 320, 1, 1),
    ]
    for t, c_out, n, stride in cfg:
        for i in range(n):
            x, s = bottleneck(x, c, c_out, stride if i == 0 else 1, t, s)
            c = c_out
    # ASPP (mobile variant: 1x1 conv + image pooling branch)
    b0 = g.op("aspp_conv1x1", [x], (1, s, s, 256))
    p = g.op("aspp_image_pool", [x], (1, 1, 1, c))
    p = g.op("aspp_pool_conv", [p], (1, 1, 1, 256))
    p = g.op("aspp_pool_upsample", [p], (1, s, s, 256))
    x = g.op("aspp_concat", [b0, p], (1, s, s, 512))
    x = g.op("aspp_project", [x], (1, s, s, 256))
    x = g.op("classifier", [x], (1, s, s, 21))
    out = g.op("upsample_bilinear", [x], (1, input_size, input_size, 21))
    g.mark_output(out)
    return g.build()


def posenet(input_size: int = 257, name: str = "posenet") -> Graph:
    """PoseNet TFLite: MobileNet v1 backbone (257², OS16 via last stride 1)
    + heatmap/offset/displacement heads (17 keypoints)."""
    g = GraphBuilder(name)
    s = input_size
    x = g.input((1, s, s, 3))
    s = _conv_out(s, 2)  # 129
    c = 32
    x = g.op("conv3x3_s2", [x], (1, s, s, c))
    blocks = [
        (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 1),
        (1024, 1),
    ]
    for out_c, stride in blocks:
        s2 = _conv_out(s, stride)
        x = g.op("dw3x3", [x], (1, s2, s2, c))
        s = s2
        x = g.op("pw1x1", [x], (1, s, s, out_c))
        c = out_c
    # heads at 1/16 resolution (17x17 for 257 input)
    hm = g.op("heatmap", [x], (1, s, s, 17))
    of = g.op("offsets", [x], (1, s, s, 34))
    df = g.op("disp_fwd", [x], (1, s, s, 32))
    db = g.op("disp_bwd", [x], (1, s, s, 32))
    for t in (hm, of, df, db):
        g.mark_output(t)
    return g.build()


def blazeface(input_size: int = 128, name: str = "blazeface") -> Graph:
    """BlazeFace (arXiv:1907.05047): 5x5 depthwise BlazeBlocks, 128² input,
    feature maps 64² -> 32² -> 16² -> 8², two detection heads. Residual
    adds are fused into the trailing pointwise conv (TFLite GPU behavior),
    so a block's add does not materialize a separate tensor."""
    g = GraphBuilder(name)
    s = input_size
    x = g.input((1, s, s, 3))
    s = _conv_out(s, 2)  # 64
    c = 24
    x = g.op("conv5x5_s2", [x], (1, s, s, c))

    def blaze(x, c_in, c_out, stride, s_in):
        s_out = _conv_out(s_in, stride)
        h = g.op("dw5x5", [x], (1, s_out, s_out, c_in))
        if stride == 2:
            p = g.op("pool_pad", [x], (1, s_out, s_out, c_out))
            h = g.op("pw1x1_add", [h, p], (1, s_out, s_out, c_out))
        else:
            h = g.op("pw1x1_add", [h, x], (1, s_out, s_out, c_out))
        return h, s_out

    def double_blaze(x, c_in, c_out, mid, stride, s_in):
        s_out = _conv_out(s_in, stride)
        h = g.op("dw5x5", [x], (1, s_out, s_out, c_in))
        h = g.op("pw1x1_proj", [h], (1, s_out, s_out, mid))
        h = g.op("dw5x5_2", [h], (1, s_out, s_out, mid))
        if stride == 2:
            p = g.op("pool_pad", [x], (1, s_out, s_out, c_out))
            h = g.op("pw1x1_add", [h, p], (1, s_out, s_out, c_out))
        else:
            h = g.op("pw1x1_add", [h, x], (1, s_out, s_out, c_out))
        return h, s_out

    x, s = blaze(x, 24, 24, 1, s)
    x, s = blaze(x, 24, 24, 1, s)
    x, s = blaze(x, 24, 48, 2, s)  # 32²
    x, s = blaze(x, 48, 48, 1, s)
    x, s = blaze(x, 48, 48, 1, s)
    x, s = double_blaze(x, 48, 96, 24, 2, s)  # 16²
    x, s = double_blaze(x, 96, 96, 24, 1, s)
    x, s = double_blaze(x, 96, 96, 24, 1, s)
    x16 = x
    x, s8 = double_blaze(x, 96, 96, 24, 2, s)  # 8²
    x, s8 = double_blaze(x, 96, 96, 24, 1, s8)
    x, s8 = double_blaze(x, 96, 96, 24, 1, s8)
    # detection heads (scores + boxes per scale; outputs are boundary)
    h16 = g.op("head16", [x16], (1, 16, 16, 2 * 18))
    h8 = g.op("head8", [x], (1, 8, 8, 6 * 18))
    g.mark_output(h16)
    g.mark_output(h8)
    return g.build()


PAPER_NETWORKS = {
    "mobilenet_v1": mobilenet_v1,
    "mobilenet_v2": mobilenet_v2,
    "deeplab_v3": deeplab_v3,
    "inception_v3": inception_v3,
    "posenet": posenet,
    "blazeface": blazeface,
}

# The paper's Tables 1-2, in MB (fp32). Keys: (table, strategy) -> net -> MB
PAPER_TABLE1 = {  # Shared Objects
    "greedy_by_size": {
        "mobilenet_v1": 4.594, "mobilenet_v2": 7.178, "deeplab_v3": 6.437,
        "inception_v3": 10.337, "posenet": 6.347, "blazeface": 0.592,
    },
    "greedy_by_size_improved": {
        "mobilenet_v1": 4.594, "mobilenet_v2": 6.891, "deeplab_v3": 6.437,
        "inception_v3": 10.337, "posenet": 6.347, "blazeface": 0.518,
    },
    "greedy_by_breadth": {
        "mobilenet_v1": 6.125, "mobilenet_v2": 6.699, "deeplab_v3": 6.437,
        "inception_v3": 10.676, "posenet": 8.390, "blazeface": 0.675,
    },
    "lower_bound": {
        "mobilenet_v1": 4.594, "mobilenet_v2": 6.604, "deeplab_v3": 6.105,
        "inception_v3": 8.955, "posenet": 6.347, "blazeface": 0.518,
    },
    "naive": {
        "mobilenet_v1": 19.248, "mobilenet_v2": 26.313, "deeplab_v3": 48.642,
        "inception_v3": 54.010, "posenet": 28.556, "blazeface": 2.698,
    },
}

PAPER_TABLE2 = {  # Offset Calculation
    "greedy_by_size": {
        "mobilenet_v1": 4.594, "mobilenet_v2": 5.742, "deeplab_v3": 4.653,
        "inception_v3": 7.914, "posenet": 6.271, "blazeface": 0.492,
    },
    "greedy_by_breadth": {
        "mobilenet_v1": 4.594, "mobilenet_v2": 5.742, "deeplab_v3": 4.653,
        "inception_v3": 7.914, "posenet": 7.359, "blazeface": 0.656,
    },
    "lower_bound": {
        "mobilenet_v1": 4.594, "mobilenet_v2": 5.742, "deeplab_v3": 4.320,
        "inception_v3": 7.914, "posenet": 6.271, "blazeface": 0.492,
    },
    "naive": {
        "mobilenet_v1": 19.248, "mobilenet_v2": 26.313, "deeplab_v3": 48.642,
        "inception_v3": 54.010, "posenet": 28.556, "blazeface": 2.698,
    },
}
