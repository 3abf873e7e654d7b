"""The port's roofline against the JAX package's: with a chip model that
carries the reference's constants (read here from ``TPU_V5E``, whose
fields are the reference roofline's module constants), ``analyze_record``
equals the reference's key for key on the same records and
``render_markdown`` equals it character for character; ``load_all``
over a temporary directory of OK, SKIP and FAIL records (and records of
another mesh or variant, which it leaves out) equals the reference's
over the same files.  With the default chip, the rates are the H100's
and ``fits_hbm`` compares the peak with its ``hbm_bytes``.
"""

import json
import math

import pytest

from repro.hw.tpu import TPU_V5E
from repro.launch import roofline as ref_roofline
from repro_torch.hw.gpu import H100_SXM, GpuChipModel
from repro_torch.launch import roofline

CHIP = GpuChipModel(peak_flops_bf16=TPU_V5E.peak_flops_bf16,
                    hbm_bw=TPU_V5E.hbm_bw,
                    nvlink_bw_per_link=TPU_V5E.ici_bw_per_link,
                    hbm_bytes=TPU_V5E.hbm_bytes)


def _record(arch, shape, *, flops, nbytes, coll, peak, args, devices=1,
            mesh="card1x1", variant="baseline", model_flops=None):
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "variant": variant,
        "status": "OK", "devices": devices,
        "memory": {"argument_bytes": args, "output_bytes": 0,
                   "temp_bytes": peak - args, "peak_bytes": peak},
        "model_flops_global": float(model_flops if model_flops is not None
                                    else flops * devices * 0.7),
        "cost": {"flops_per_device": flops, "bytes_per_device": nbytes,
                 "collective_bytes_per_device": coll,
                 "collective_by_op_per_device": {}},
    }


RECORDS = [
    _record("qwen2-7b", "decode_32k", flops=3.5e12, nbytes=2.6e11,
            coll=0.0, peak=240 * 2**30, args=239 * 2**30),
    _record("tinyllama-1.1b", "train_4k", flops=9.7e15, nbytes=4.2e13,
            coll=0.0, peak=15 * 2**30, args=10 * 2**30),
    _record("kimi-k2-1t-a32b", "prefill_32k", flops=3.0e14, nbytes=1.1e12,
            coll=4.0e11, peak=16 * 2**30 - 1, args=2**33, devices=256,
            mesh="pod16x16"),
    _record("xlstm-350m", "long_500k", flops=0.0, nbytes=0.0, coll=0.0,
            peak=2**20, args=2**20, model_flops=1.0),
]


def test_chip_constants_are_the_reference_rooflines():
    assert (CHIP.peak_flops_bf16, CHIP.hbm_bw, CHIP.nvlink_bw_per_link) == \
        (ref_roofline.PEAK_FLOPS, ref_roofline.HBM_BW, ref_roofline.ICI_BW)
    assert CHIP.hbm_bytes == 16 * 2**30


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: r["arch"])
def test_analyze_record_equals_the_reference(rec):
    got = roofline.analyze_record(rec, CHIP)
    want = ref_roofline.analyze_record(rec)
    assert list(got) == list(want)
    for key, val in want.items():
        if isinstance(val, float) and math.isnan(val):
            assert math.isnan(got[key])
        else:
            assert got[key] == val, key


def test_skipped_and_failed_records_give_no_row():
    for rec in ({"status": "SKIP"}, {"status": "FAIL"},
                {"status": "OK"}):
        assert roofline.analyze_record(rec, CHIP) is None
        assert ref_roofline.analyze_record(rec) is None


def test_render_markdown_equals_the_reference():
    rows = [roofline.analyze_record(r, CHIP) for r in RECORDS]
    ref_rows = [ref_roofline.analyze_record(r) for r in RECORDS]
    rows += [{"arch": "a", "shape": "s", "mesh": "m", "skip": "why"},
             {"arch": "b", "shape": "s", "mesh": "m", "fail": "x" * 90}]
    ref_rows += rows[-2:]
    assert roofline.render_markdown(rows) == \
        ref_roofline.render_markdown(ref_rows)


def test_load_all_equals_the_reference(tmp_path, monkeypatch):
    recs = list(RECORDS) + [
        {"arch": "phi3-mini-3.8b", "shape": "long_500k", "mesh": "card1x1",
         "variant": "baseline", "status": "SKIP", "reason": "full attention"},
        {"arch": "hymba-1.5b", "shape": "train_4k", "mesh": "card1x1",
         "variant": "baseline", "status": "FAIL", "error": "E" * 100},
        dict(RECORDS[1], variant="noremat"),
    ]
    for rec in recs:
        tag = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}" + (
            "" if rec["variant"] == "baseline" else f"_{rec['variant']}")
        (tmp_path / f"{tag}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(ref_roofline, "ARTIFACTS", tmp_path)
    for mesh in ("card1x1", "pod16x16"):
        for variant in ("baseline", "noremat"):
            got = roofline.load_all(mesh, variant, chip=CHIP,
                                    directory=tmp_path)
            # as JSON text: a NaN ratio equals itself there
            assert json.dumps(got) == \
                json.dumps(ref_roofline.load_all(mesh, variant))
    rows = roofline.load_all(directory=tmp_path)
    assert [r["arch"] for r in rows] == [
        "hymba-1.5b", "phi3-mini-3.8b", "qwen2-7b", "tinyllama-1.1b",
        "xlstm-350m"]
    assert "fail" in rows[0] and "skip" in rows[1]


def test_default_chip_is_the_h100():
    rec = RECORDS[0]
    row = roofline.analyze_record(rec)
    assert row["t_compute_s"] == 3.5e12 / 989e12
    assert row["t_memory_s"] == 2.6e11 / 3.35e12
    assert row["fits_hbm"] is False         # 240 GiB on one card
    small = dict(rec, memory=dict(rec["memory"], peak_bytes=2**36))
    assert roofline.analyze_record(small)["fits_hbm"] is True
    edge = dict(rec, memory=dict(rec["memory"],
                                 peak_bytes=H100_SXM.hbm_bytes))
    assert roofline.analyze_record(edge)["fits_hbm"] is False
