"""Operations and bytes that the work of a unit needs, from its shapes.

These are the yardstick of the per-layer shares: they count what the
inputs need, whatever code does the work, and never more. Where the work
depends on data that the benchmark cannot see (the rows that a run-length
backward keeps, the distinct slots of a gather, the tokens that survive
the voxel subsample), the count takes the least amount the inputs surely
need, so that a share read against it cannot pass 100 %.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at
the full 700 W power limit.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


# ------------------------------------------------------------------ NGP field

def ngp_density_macs(cfg: dict) -> int:
    """Multiply-adds of one point through the density MLP."""
    d = cfg["density_mlp"]
    return sum(a * b for a, b in zip(d[:-1], d[1:]))


def ngp_color_macs(cfg: dict) -> int:
    """Multiply-adds of one point and direction through the colour MLP."""
    c = cfg["color_mlp"]
    return sum(a * b for a, b in zip(c[:-1], c[1:]))


def ngp_encode_flops(cfg: dict) -> int:
    """The trilinear blend of one point: 8 corners times the features of
    every level, a multiply and an add each (the weights not counted)."""
    g = cfg["grid"]
    return 2 * 8 * g["n_levels"] * g["n_features"]


def ngp_train_sample_flops(cfg: dict) -> int:
    """One marched sample of a training step: both MLPs forward and
    backward (the backward takes two products per forward product: the
    input's and the weight's gradient) and the blend forward and
    backward."""
    macs = ngp_density_macs(cfg) + ngp_color_macs(cfg)
    return 3 * 2 * macs + 2 * ngp_encode_flops(cfg)


def ngp_density_point_flops(cfg: dict) -> int:
    """One point's density query, forward only."""
    return 2 * ngp_density_macs(cfg) + ngp_encode_flops(cfg)


def packed_row_width(cfg: dict) -> int:
    """Floats of one packed-table row: 8 corners of a level's features."""
    return 8 * cfg["grid"]["n_features"]


def level_table_rows(cfg: dict) -> list[int]:
    """Rows of each level's table: the dense grid where it fits, else
    2^log2_table_size (the packed layout of the configuration)."""
    import math

    g = cfg["grid"]
    out = []
    for level in range(g["n_levels"]):
        scale = g["base_resolution"] * g["per_level_scale"] ** level - 1.0
        res = math.ceil(scale) + 1
        out.append(min(res ** 3, 1 << g["log2_table_size"]))
    return out


def k2p_bytes(rows: int, width: int) -> int:
    """A row gather of `rows` rows of `width` f32: the indices read and the
    rows written (each distinct table row read at least once is not
    counted: the benchmark cannot see how many are distinct)."""
    return 4 * rows + 4 * rows * width


def k1p_bytes(rows_in: int, width: int, table_rows: int) -> int:
    """A bf16 sum-scatter of `rows_in` f32 rows into a fresh bf16 table of
    `table_rows` rows: indices and rows read, the table written once."""
    return 4 * rows_in + 4 * rows_in * width + 2 * table_rows * width


# ------------------------------------------------------------------ NeRFRegTr

def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def regtr_fpn_convs(cfg: dict, res: int) -> list[tuple[str, int]]:
    """(name, multiply-adds) of every convolution of the FPN over one
    grid side of `res`^3 voxels: the bottleneck ResNet-3D (5^3 stride-2
    stem, 3^3 stride-2 max pool, stages of `blocks` bottlenecks) and the
    top-down pyramid of 1^3 laterals and 3^3 smoothing convolutions."""
    convs = []

    def conv(name, n, cin, cout, k, s, p):
        m = _conv_out(n, k, s, p)
        convs.append((name, m ** 3 * cin * cout * k ** 3))
        return m

    b = cfg["backbone"]
    n1 = conv("stem", res, b["in_channels"], b["stem_width"], 5, 2, 2)
    n = _conv_out(n1, 3, 2, 1)
    cin, sizes = b["stem_width"], []
    for stage, (planes, blocks, stride) in enumerate(
            zip(b["planes"], b["blocks"], b["strides"])):
        for i in range(blocks):
            s = stride if i == 0 else 1
            out = planes * b["expansion"]
            conv(f"s{stage}b{i}.a", n, cin, planes, 1, 1, 0)
            m = conv(f"s{stage}b{i}.b", n, planes, planes, 3, s, 1)
            conv(f"s{stage}b{i}.c", m, planes, out, 1, 1, 0)
            if s != 1 or cin != out:
                conv(f"s{stage}b{i}.proj", n, cin, out, 1, s, 0)
            n, cin = m, out
        sizes.append((n, cin))
    co = cfg["d_model"]
    (n2, c2), (n3, c3), (n4, c4), (n5, c5) = sizes
    conv("lateral5", n5, c5, co, 1, 1, 0)
    conv("lateral4", n4, c4, co, 1, 1, 0)
    conv("smooth4", n4, co, co, 3, 1, 1)
    conv("lateral3", n3, c3, co, 1, 1, 0)
    conv("smooth3", n3, co, co, 3, 1, 1)
    conv("lateral2", n2, c2, co, 1, 1, 0)
    conv("smooth2", n2, co, co, 3, 1, 1)
    conv("lateral1", n1, b["stem_width"], co, 3, 1, 1)
    conv("smooth1", n1, co, co, 3, 1, 1)
    return convs


def regtr_forward_flops(cfg: dict, res: int) -> int:
    """The pair's forward: both sides' FPN convolutions. The transformer
    and the decoder (under 2 % at the configuration's sizes) run on the
    tokens that survive the subsample, which the benchmark cannot see, and
    are not counted."""
    return 2 * 2 * sum(m for _, m in regtr_fpn_convs(cfg, res))


def regtr_train_flops(cfg: dict, res: int) -> int:
    """A training step on one pair: the forward, and the backward's two
    products a forward product (the input's and the weight's gradient),
    less the stem's input gradient, which nothing needs."""
    convs = regtr_fpn_convs(cfg, res)
    total = sum(m for _, m in convs)
    stem = convs[0][1]
    return 2 * 2 * (3 * total - stem)
