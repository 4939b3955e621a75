"""The yardstick's arithmetic: the H100's peaks, the PE + attention
kernels' least times (frozen from the program's measuring helpers, counted
on valid slots), and the least time of a whole training step or evaluation
sweep of LPFormer, from the configuration's shapes alone.

A least time is the larger of two quotients: the bytes over the HBM
bandwidth, and the operations over the peak rate of their kind (matrix
products at the bf16 tensor rate when their inputs are bf16, the rest at
the f32 rate). Each input byte is read once and each output byte written
once.
"""
from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12


def least_s(nbytes: float, mm_flops: float, f32_flops: float,
            mm_bf16: bool) -> float:
    mm_rate = BF16_TENSOR_FLOPS if mm_bf16 else F32_FLOPS
    return max(nbytes / HBM_BYTES_PER_S,
               mm_flops / mm_rate + f32_flops / F32_FLOPS)


def pe_fwd_least_s(keys_shape, w1_shape, kb: int, nv: int) -> float:
    """The combined-table PE + attention forward on keys [B, C, O] with K
    encoders of width dh and ``nv`` valid slots: the valid mask, q, the
    weights and the outputs once; per valid slot its key row, ps, pt and
    class (12 bytes); 2 dh O tensor operations and ~(12 dh + 8 O) f32
    operations per valid slot."""
    b, c, o = keys_shape
    k, _, dh = w1_shape
    nbytes = (b * c + 4 * b * o + nv * (o * kb + 12) + 4 * k * dh * 5
              + kb * k * dh * o + 4 * (k * o + 2 * o) + 4 * b * o + 8 * b)
    return least_s(nbytes, nv * 2 * dh * o, nv * (12 * dh + 8 * o), kb == 2)


def pe_bwd_least_s(keys_shape, w1_shape, kb: int, nv: int) -> float:
    """Its backward: the valid mask, q, g_out, m, l, delta and the weights
    once, per valid slot its key row, ps, pt and class; all of dkeys
    [B, C, O], dq and the weight grads written once. Three dh x O products
    per valid slot at the tensor rate, ~(40 dh + 30 O) f32 operations."""
    b, c, o = keys_shape
    k, _, dh = w1_shape
    inputs = (b * c + 2 * 4 * b * o + 3 * 4 * b + nv * (o * kb + 12)
              + 4 * k * dh * 5 + kb * k * dh * o + 4 * (k * o + o))
    outputs = (b * c * o * kb + 4 * b * o + 4 * k * dh * 5
               + 4 * k * dh * o + 4 * (k * o + o))
    return least_s(inputs + outputs, nv * 3 * 2 * dh * o,
                   nv * (40 * dh + 30 * o), kb == 2)


def _param_count(cfg) -> int:
    d, f = cfg["dim"], cfg["feat_dim"]
    gcn = f * d + (cfg["gnn_layers"] - 1) * d * d + cfg["gnn_layers"] * 3 * d
    mlp = lambda i, h, o: i * h + h + h * o + o + 2 * h  # noqa: E731
    return (gcn + 2 * d + mlp(d, d, d) + 3 * mlp(2, d, d)
            + (d * d + d) + (2 * d * d + d) + 5 * d
            + mlp(d + 4, d + 4, d) + (4 * d * d + 2 * d + 2 * d + 1))


def _forward(cfg, links: float, slots: float):
    """(tensor ops, f32 ops, bytes of each link's rows) of LPFormer's
    forward over ``links`` links with ``slots`` valid context slots in
    all: per link the elementwise, query, pairwise and score MLPs; per
    valid slot the symmetric PPR encoder, the key projection of
    [x_v || pe_v] and the attention."""
    d = cfg["dim"]
    per_link = 2 * (2 * d * d + 2 * d * d + (d + 4) * (2 * d + 4)
                    + 4 * d * d + 2 * d)
    per_slot = 2 * (2 * (2 * d + d * d)) + 2 * 2 * d * d
    row_bytes = 2 * (cfg["adj_cap"] * 12 + cfg["ppr_cap"] * 9) + 16
    return (links * per_link + slots * per_slot, slots * 10 * d,
            links * row_bytes)


def _propagation(cfg, num_entries: int):
    """(tensor ops, f32 ops, bytes): the GCN's dense products, its sparse
    products over the normalised adjacency's ``num_entries`` entries (self
    loops included; a gather-sum, at the f32 rate), the features and the
    adjacency (two ids and a weight an entry) read once."""
    n, d, f, nl = (cfg["num_nodes"], cfg["dim"], cfg["feat_dim"],
                   cfg["gnn_layers"])
    dense = 2 * n * d * (f + (nl - 1) * d)
    sparse = 2 * num_entries * d * nl
    return dense, sparse, n * f * 4 + num_entries * 12


def train_step_least_s(cfg, num_entries: int, slots_pos: float,
                       slots_neg: float) -> float:
    """A training step on a batch of B positives and B negatives with the
    given mean valid slots a link: one propagation, both halves' forwards,
    the backward (twice the forward's operations), and the parameters and
    Adam's two moments read and written once."""
    b = cfg["batch_size"]
    pt, pf, pb = _propagation(cfg, num_entries)
    ft, ff, fb = _forward(cfg, 2 * b, b * (slots_pos + slots_neg))
    nbytes = pb + fb + 6 * 4 * _param_count(cfg)
    return least_s(nbytes, 3 * (pt + ft), 3 * (pf + ff),
                   cfg["matmul_dtype"] == "bfloat16")


def eval_sweep_least_s(cfg, num_entries: int, links: int,
                       slots: float) -> float:
    """An evaluation sweep: one propagation and the forward over ``links``
    links with ``slots`` mean valid slots a link, a score written for
    each."""
    pt, pf, pb = _propagation(cfg, num_entries)
    ft, ff, fb = _forward(cfg, links, links * slots)
    return least_s(pb + fb + 4 * links, pt + ft, pf + ff,
                   cfg["matmul_dtype"] == "bfloat16")
