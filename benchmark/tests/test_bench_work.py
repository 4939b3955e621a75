"""The yardstick's operation and byte counts against hand-worked cases."""
import pytest

from lpbench import work


def test_least_s_takes_the_larger_bound():
    # 3.35e12 bytes take a second; 989e12 bf16 tensor operations a second
    assert work.least_s(3.35e12, 0, 0, True) == pytest.approx(1.0)
    assert work.least_s(0, 989e12, 0, True) == pytest.approx(1.0)
    assert work.least_s(0, 67e12, 0, False) == pytest.approx(1.0)
    assert work.least_s(1.0, 989e12, 67e12, True) == pytest.approx(2.0)


def test_pe_fwd_bytes_by_hand():
    # B 2, C 4, O 8, K 3 encoders of width dh 8, bf16 keys, 5 valid slots:
    # mask 8 + q 64 + slots 5 * (8 * 2 + 12) = 140 + w1/b1/g/b 4*3*8*5 = 480
    # + w2f 2*3*8*8 = 384 + cbias/att/bias 4*(24 + 16) = 160 + out 64 + 16
    nbytes = 8 + 64 + 140 + 480 + 384 + 160 + 64 + 16
    assert work.pe_fwd_least_s((2, 4, 8), (3, 2, 8), 2, 5) == pytest.approx(
        nbytes / work.HBM_BYTES_PER_S)


def test_pe_bwd_bytes_by_hand():
    # inputs: 8 + 2*4*2*8 = 128 + 3*4*2 = 24 + 140 + 480 + 384 + 4*(24+8)
    # outputs: dkeys' 5 valid rows 5*8*2 = 80 + dq 64 + 480 + 4*3*8*8 = 768
    # + 128
    nbytes = (8 + 128 + 24 + 140 + 480 + 384 + 128) + (80 + 64 + 480 + 768
                                                       + 128)
    assert work.pe_bwd_least_s((2, 4, 8), (3, 2, 8), 2, 5) == pytest.approx(
        nbytes / work.HBM_BYTES_PER_S)


def test_pe_fwd_operations_bound_when_dense():
    # f32 keys [1000, 100, 64], one encoder of width 64, 100,000 valid
    # slots: 2*64*64 + 20*64 f32 operations a slot outweigh its 268 bytes
    t = work.pe_fwd_least_s((1000, 100, 64), (1, 2, 64), 4, 100_000)
    ops = 100_000 * (2 * 64 * 64 + 12 * 64 + 8 * 64) / work.F32_FLOPS
    assert t == pytest.approx(ops)


CFG = {"num_nodes": 10, "dim": 2, "feat_dim": 3, "gnn_layers": 1,
       "batch_size": 1, "adj_cap": 1, "ppr_cap": 1,
       "matmul_dtype": "float32"}


def test_eval_sweep_by_hand():
    # propagation: dense 2*10*2*3 = 120, sparse 2*5*2*1 = 20 (f32), bytes
    # 10*3*4 + 5*12 = 180; one link with one slot: per link 2*(8+8+6*8+16
    # + 4) = 168, per slot 2*(2*(4+4)) + 16 = 48 tensor and 20 f32
    # operations, bytes 2*(12+9)+16 = 58 and a score 4
    t = work.eval_sweep_least_s(CFG, 5, 1, 1.0)
    ops = (120 + 168 + 48 + 20 + 20) / work.F32_FLOPS
    assert t == pytest.approx(max(ops, (180 + 58 + 4) / work.HBM_BYTES_PER_S))


def test_train_step_counts_three_passes():
    cfg = dict(CFG, matmul_dtype="bfloat16")
    one = work.eval_sweep_least_s(dict(cfg, batch_size=1), 5, 2, 0.0)
    t = work.train_step_least_s(cfg, 5, 0.0, 0.0)
    assert t > one
