"""The dry-run (``repro_torch.launch.dryrun``) and its counter
(``repro_torch.launch._count``) on ``meta`` tensors, on the CPU:

  - the counter's FLOPs of a prefill (and a dense decode step) of
    reduced dense, moe (MLA), hybrid, ssm and audio configs against an
    analytic count written here: 2·M·N·K a product, 4·D a kept (query,
    key) pair for the attention kernel (hymba's window and whisper's
    non-causal encoder and cross-attention included), 4·D a cache row
    for the decode kernel;
  - the byte rules of the counter's docstring on a hand-made program;
  - the MoE's balanced route: T·k expert FFN rows, the reference
    oracle's work;
  - layer-differenced costs equal to the direct full-depth count (a
    forward's eager counts are linear in L) and the linear scaling of
    long ssm and hybrid cells, whose memory and raw costs come from the
    full-length run;
  - ``model_flops_global``, ``n_params``, ``n_active_params`` and
    ``tokens`` against the reference's formulas, and ``run_cell`` at
    full width on a cell of each family: the record's keys, no
    parameter allocated;
  - the variants the port refuses by name.

Every comparison is exact.
"""

import dataclasses
import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as ref_configs
import repro_torch.configs as configs
from repro_torch.configs import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch._count import CostCounter
from repro_torch.models import module
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf

B, S = 2, 16


def _reduced(arch: str, **kw):
    return configs.get_config(arch).reduced(**kw)


REDUCED = {
    "tinyllama-1.1b": _reduced("tinyllama-1.1b"),
    # D = 16 + 16: a head dim the attention kernel is built for
    "deepseek-v2-lite-16b": _reduced("deepseek-v2-lite-16b",
                                     rope_head_dim=16),
    "hymba-1.5b": _reduced("hymba-1.5b"),
    "xlstm-350m": _reduced("xlstm-350m", slstm_every=2),
    "whisper-large-v3": _reduced("whisper-large-v3"),
    "qwen2-vl-72b": _reduced("qwen2-vl-72b"),
}


@pytest.fixture
def reduced_cells(monkeypatch, tmp_path):
    """The dry-run on the reduced configs, at cells of B = 2, S = 16
    (decode over a cache of 16 rows), writing records to ``tmp_path``."""
    monkeypatch.setattr(configs, "get_config", lambda arch: REDUCED[arch])
    monkeypatch.setitem(configs.SHAPES, "prefill_32k",
                        ShapeCell("prefill_32k", S, B, "prefill"))
    monkeypatch.setitem(configs.SHAPES, "decode_32k",
                        ShapeCell("decode_32k", S, B, "decode"))
    monkeypatch.setitem(configs.SHAPES, "train_4k",
                        ShapeCell("train_4k", S, B, "train"))
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    return tmp_path


def _pairs(sq, sk, causal=True, window=0, q_offset=0):
    n = 0
    for i in range(sq):
        p = q_offset + i
        for j in range(sk):
            if causal and j > p:
                continue
            if window and p - j >= window:
                continue
            n += 1
    return n


def _mm(m, k, n):
    return 2 * m * k * n


def _attn_proj(cfg, t):
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return (_mm(t, d, h * hd) + 2 * _mm(t, d, kh * hd)
            + _mm(t, h * hd, d))


def _ffn(cfg, t):
    n = 3 if cfg.act == "swiglu" else 2
    return n * _mm(t, cfg.d_model, cfg.d_ff)


def _head(cfg, rows):
    return _mm(rows, cfg.d_model, cfg.padded_vocab)


def _gls(b, s, h, dk, dv, chunk):
    """The chunked scan's einsums (all on bmm)."""
    c = min(chunk, s)
    per = (_mm(c, dk, dv) + _mm(c, dk, 1) + _mm(c, dk, c) + _mm(c, c, dv)
           + _mm(dk, c, dv)) * b * h
    return per * (-(-s // c))


def dense_prefill(cfg):
    t, h, hd = B * S, cfg.n_heads, cfg.hd
    layer = _attn_proj(cfg, t) + _ffn(cfg, t) + 4 * hd * B * h * _pairs(S, S)
    return cfg.n_layers * layer + _head(cfg, B)


def moe_prefill(cfg):
    t, d, h, kh, hd = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    r, dr, fe = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.d_ff_expert
    attn = (_mm(t, d, h * (hd + dr)) + _mm(t, d, r + dr)
            + 2 * _mm(t, r, kh * hd) + _mm(t, h * hd, d)
            + 4 * (hd + dr) * B * h * _pairs(S, S))
    experts = (_mm(t, d, cfg.n_experts)
               + t * cfg.moe_top_k * 3 * _mm(1, d, fe)
               + 3 * _mm(t, d, cfg.n_shared_experts * fe))
    return cfg.n_layers * (attn + experts) + _head(cfg, B)


def hybrid_prefill(cfg):
    t, d, h, hd, ss = B * S, cfg.d_model, cfg.n_heads, cfg.hd, cfg.ssm_state
    attn = _attn_proj(cfg, t) + 4 * hd * B * h * _pairs(S, S,
                                                        window=cfg.window)
    mamba = (2 * _mm(t, d, h * ss) + _mm(t, d, h * hd) + _mm(t, d, h)
             + _gls(B, S, h, ss, hd, cfg.gls_chunk))
    return cfg.n_layers * (attn + mamba + _ffn(cfg, t)) + _head(cfg, B)


def ssm_prefill(cfg):
    t, d, h = B * S, cfg.d_model, cfg.n_heads
    di = d * cfg.proj_factor
    dh = di // h
    mlstm = (2 * _mm(t, d, di) + 3 * _mm(t, di, di) + 2 * _mm(t, di, h)
             + _mm(t, di, d) + _gls(B, S, h, dh, dh, cfg.gls_chunk))
    sdh = d // h
    slstm = (_mm(t, d, 4 * d) + S * 4 * B * h * _mm(1, sdh, sdh)
             + 2 * _mm(t, d, d))
    n_s = sum((i + 1) % cfg.slstm_every == 0 for i in range(cfg.n_layers))
    return (cfg.n_layers - n_s) * mlstm + n_s * slstm + _head(cfg, B)


def audio_prefill(cfg):
    t, h, kh, hd, d = B * S, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    es = cfg.encoder_seq
    te = B * es
    enc = (_attn_proj(cfg, te) + 4 * hd * B * h * _pairs(es, es, False)
           + _ffn(cfg, te))
    dec = (_attn_proj(cfg, t) + 4 * hd * B * h * _pairs(S, S)
           + _mm(t, d, h * hd) + 2 * _mm(te, d, kh * hd)
           + 4 * hd * B * h * S * es + _mm(t, h * hd, d) + _ffn(cfg, t))
    return (cfg.n_encoder_layers * enc + cfg.n_layers * dec
            + _head(cfg, B))


ANALYTIC = {"tinyllama-1.1b": dense_prefill,
            "deepseek-v2-lite-16b": moe_prefill,
            "hymba-1.5b": hybrid_prefill,
            "xlstm-350m": ssm_prefill,
            "whisper-large-v3": audio_prefill,
            "qwen2-vl-72b": dense_prefill}


@pytest.mark.parametrize("arch", list(ANALYTIC))
def test_prefill_flops_equal_the_analytic_count(arch, reduced_cells):
    res = dryrun.count_pass(arch, "prefill_32k")
    assert res["flops"] == ANALYTIC[arch](REDUCED[arch])
    assert res["bytes"] > 0
    mem = res["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["output_bytes"]


def test_dense_decode_flops_equal_the_analytic_count(reduced_cells):
    cfg = REDUCED["tinyllama-1.1b"]
    res = dryrun.count_pass("tinyllama-1.1b", "decode_32k")
    layer = (_attn_proj(cfg, B) + _ffn(cfg, B)
             + 4 * cfg.hd * B * cfg.n_heads * S)   # every cache row
    assert res["flops"] == cfg.n_layers * layer + _head(cfg, B)


def test_counter_byte_rules():
    f32 = dict(dtype=torch.float32, device="meta")
    cache = torch.empty(4, 100, 8, **f32)
    table = torch.empty(1000, 8, **f32)
    counter = CostCounter()
    assert counter.hold(cache, table, cache[1]) == (3200 + 8000) * 4
    with counter:
        v = cache.transpose(0, 1)[:, :2].unsqueeze(0)[0, 3]   # views
        assert v.shape == (2, 8)
        assert counter.bytes == 0
        rows = torch.empty(4, 8, **f32)                     # no values
        assert counter.bytes == 0
        idx = torch.zeros(4, dtype=torch.int64, device="meta")
        assert counter.bytes == 32                          # written
        ar = torch.arange(4, device="meta")
        nbytes = counter.bytes
        cache[ar, idx] = rows                                # one row each
        # rows and both indices read, the rows' bytes written
        assert counter.bytes - nbytes == 128 + 2 * 32 + 128
        nbytes = counter.bytes
        picked = table[idx]                                 # a gather
        # the rows it returns read and written, the indices read
        assert counter.bytes - nbytes == 2 * 128 + 32
        nbytes = counter.bytes
        rows.mul_(2.0)                                      # in place
        assert counter.bytes - nbytes == 2 * 128
        nbytes = counter.bytes
        rows.copy_(picked)                                  # a pure write
        assert counter.bytes - nbytes == 2 * 128
        nbytes = counter.bytes
        out = rows @ torch.empty(8, 16, **f32)
        assert counter.flops == 2 * 4 * 8 * 16
        assert counter.bytes - nbytes == 128 + 512 + 256
        del v, out
    # held, rows, idx, ar, picked; out freed
    assert counter.live == (3200 + 8000) * 4 + 128 + 32 + 32 + 128
    assert counter.peak >= counter.live


@pytest.mark.parametrize("t,k,e", [(7, 3, 8), (64, 6, 64), (5, 2, 3)])
def test_moe_balanced_route_is_t_k_expert_rows(t, k, e):
    d, f = 16, 24
    dims = moe_lib.MoeDims(e, k, d, f)
    counts = moe_lib.balanced_counts(t * k, e)
    assert sum(counts) == t * k and max(counts) - min(counts) <= 1
    meta = dict(dtype=torch.float32, device="meta")
    counter = CostCounter()
    with counter:
        out = moe_lib.moe_ffn_dense(
            torch.empty(t, d, **meta), torch.empty(d, e, **meta),
            torch.empty(e, d, f, **meta), torch.empty(e, d, f, **meta),
            torch.empty(e, f, d, **meta), dims)
    assert out.shape == (t, d) and out.is_meta
    assert counter.flops == _mm(t, d, e) + t * k * 3 * _mm(1, d, f)


@pytest.mark.parametrize("arch", list(ANALYTIC))
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_layer_differencing_equals_the_full_depth_count(arch, shape,
                                                        reduced_cells):
    cfg = REDUCED[arch]
    if cfg.family == "ssm":   # three layers, one of them sLSTM
        assert cfg.n_layers == 3 and cfg.slstm_every == 2
    elif cfg.family == "audio":   # encoder and decoder layers go together
        REDUCED[arch] = dataclasses.replace(cfg, n_layers=5,
                                            n_encoder_layers=5)
    else:
        REDUCED[arch] = dataclasses.replace(cfg, n_layers=5)
    try:
        rec = dryrun.run_cell(arch, shape, force=True)
    finally:
        REDUCED[arch] = cfg
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["cost"]["flops_per_device"] == \
        rec["cost_raw"]["flops_per_device"]
    assert rec["cost"]["bytes_per_device"] == \
        rec["cost_raw"]["bytes_per_device"]


def test_train_flops_difference_exactly(reduced_cells):
    rec = dryrun.run_cell("tinyllama-1.1b", "train_4k", force=True)
    assert rec["status"] == "OK"
    assert rec["cost"]["flops_per_device"] == \
        rec["cost_raw"]["flops_per_device"]
    assert rec["memory"]["output_bytes"] < 64    # in place: the metrics


@pytest.mark.parametrize("arch", ["xlstm-350m", "hymba-1.5b"])
def test_long_ssm_and_hybrid_cells_scale_linearly(arch, reduced_cells,
                                                  monkeypatch):
    """Past ``SCALE_SEQ`` (32 tokens here) an ssm or hybrid prefill is
    costed at ``SCALE_SEQ`` and scaled linearly, as the reference does;
    its memory and ``cost_raw`` come from the full-length run."""
    monkeypatch.setitem(configs.SHAPES, "prefill_32k",
                        ShapeCell("prefill_32k", 64, B, "prefill"))
    monkeypatch.setattr(dryrun, "SCALE_SEQ", 32)
    rec = dryrun.run_cell(arch, "prefill_32k", force=True)
    direct = dryrun.count_pass(arch, "prefill_32k")
    assert rec["memory"] == direct["memory"]
    assert rec["cost_raw"] == {"flops_per_device": float(direct["flops"]),
                               "bytes_per_device": float(direct["bytes"])}
    plan = dryrun.cell_plan(arch, "prefill_32k")
    assert plan["scale"] == 2.0 and plan["a"][3] == 32
    a = dryrun.count_pass(*plan["a"])
    b = dryrun.count_pass(*plan["b"])
    cfg = REDUCED[arch]
    for key in ("flops", "bytes"):
        per_layer = (b[key] - a[key]) * 2.0
        base = a[key] * 2.0 - per_layer
        if "special" in plan:
            n_s = cfg.n_layers // cfg.slstm_every
            s_layer = dryrun.count_pass(*plan["special"])[key] * 2.0 - base
            want = base + (cfg.n_layers - n_s) * per_layer + n_s * s_layer
        else:
            want = base + cfg.n_layers * per_layer
        assert rec["cost"][f"{key}_per_device"] == want


class _HostAllocations(TorchDispatchMode):
    """The most elements of any tensor an operation returns off ``meta``."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                self.largest = max(self.largest, t.numel())
        return out


SCHEMA = {"arch", "shape", "mesh", "variant", "status", "run_s", "devices",
          "memory", "cost_raw", "collectives_raw",
          "model_flops_global", "n_params", "n_active_params", "tokens",
          "cost"}

FULL_WIDTH = [("tinyllama-1.1b", "decode_32k"),
              ("tinyllama-1.1b", "prefill_32k"),
              ("tinyllama-1.1b", "train_4k"),
              ("deepseek-v2-lite-16b", "decode_32k"),
              ("qwen2-vl-72b", "decode_32k"),
              ("whisper-large-v3", "decode_32k"),
              ("hymba-1.5b", "long_500k"),
              ("xlstm-350m", "decode_32k")]


@pytest.mark.parametrize("arch,shape", FULL_WIDTH)
def test_run_cell_at_full_width(arch, shape, tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    watch = _HostAllocations()
    with watch:
        rec = dryrun.run_cell(arch, shape)
    assert watch.largest < 1024            # no parameter, no cache
    assert rec["status"] == "OK", rec.get("traceback")
    assert set(rec) == SCHEMA
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert set(rec["cost"]) == {
        "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "collective_by_op_per_device",
        "method", "cost_pass_s"}
    assert set(rec["cost_raw"]) == {"flops_per_device", "bytes_per_device"}
    assert rec["collectives_raw"] == {"bytes_per_device_by_op": {},
                                      "counts": {},
                                      "bytes_per_device_total": 0.0}
    assert rec["cost"]["collective_bytes_per_device"] == 0.0
    assert (rec["mesh"], rec["devices"], rec["variant"]) == \
        ("card1x1", 1, "baseline")
    # the reference's formulas
    ref_cfg = ref_configs.get_config(arch)
    cell = ref_configs.SHAPES[shape]
    tokens = cell.tokens if cell.kind != "decode" else cell.global_batch
    assert rec["tokens"] == tokens
    assert rec["n_params"] == ref_cfg.n_params()
    assert rec["n_active_params"] == ref_cfg.active_params()
    assert rec["model_flops_global"] == float(
        (6 if cell.kind == "train" else 2) * ref_cfg.active_params()
        * tokens)
    # written, and read back unless forced
    path = tmp_path / f"{arch}_{shape}_card1x1.json"
    assert json.loads(path.read_text()) == rec
    assert dryrun.run_cell(arch, shape) == rec


def test_argument_bytes_are_the_step_inputs(tmp_path, monkeypatch):
    """tinyllama's decode cell: parameters, both caches, lengths and
    tokens, byte for byte."""
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k")
    cfg = configs.get_config("tinyllama-1.1b")
    cell = configs.SHAPES["decode_32k"]
    params = module.param_bytes(tf.abstract(cfg))
    cache = 2 * 2 * cfg.n_layers * cell.global_batch * cell.seq_len \
        * cfg.n_kv_heads * cfg.hd
    assert rec["memory"]["argument_bytes"] == \
        params + cache + 4 * cell.global_batch * 2


def test_skip_records_and_the_list(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    rec = dryrun.run_cell("qwen2-7b", "long_500k")
    ok, why = ref_configs.cell_applicable(ref_configs.get_config("qwen2-7b"),
                                          "long_500k")
    assert not ok
    assert rec == {"arch": "qwen2-7b", "shape": "long_500k",
                   "mesh": "card1x1", "variant": "baseline",
                   "status": "SKIP", "reason": why}
    dryrun.main(["--list"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 40
    assert sum(" RUN" in line for line in lines) == 32


def test_variants_the_port_does_not_read_raise_by_name(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    assert dryrun.variant_overrides("noremat") == {"remat": False}
    assert dryrun.variant_overrides("cap10int8") == {
        "capacity_factor": 1.0, "moe_dispatch_dtype": "int8"}
    for name in ("bigchunk", "donate"):
        with pytest.raises(ValueError, match=name):
            dryrun.run_cell("tinyllama-1.1b", "decode_32k", variant=name)
    # ported (Queue 1 item 5c): on one card there is no "model" axis to
    # cut the cache over, so the records equal the baseline's
    base = dryrun.run_cell("tinyllama-1.1b", "decode_32k")
    for name in ("kvseq", "kvseqdonate"):
        assert dryrun.variant_overrides(name) == {"shard_kv_seq": True}
        rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", variant=name)
        assert rec["status"] == "OK" and rec["variant"] == name
        assert rec["memory"] == base["memory"]
    with pytest.raises(ValueError, match="unknown"):
        dryrun.variant_overrides("nosuch")
    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", variant="noremat")
    assert rec["variant"] == "noremat"
    assert (tmp_path / "tinyllama-1.1b_decode_32k_card1x1_noremat.json") \
        .exists()
