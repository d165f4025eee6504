"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's: the same record keys and table, with one H100's peaks in place
of a 256-chip v5e pod's and the chip count read from the record.  Each
term is the reference's scaled by the ratio of the two rooflines' peaks;
the dominant term and the fractions follow the port's own terms."""

import json
import sys

import pytest

from repro.configs import get_config as jax_config
from repro.config import SHAPES as JSHAPES
from repro.launch import costs as jcosts
from repro.launch import roofline as jroof
from repro_torch.launch import roofline

CELLS = [("gemma2-2b", "train_4k", "memcom_train"),
         ("whisper-medium", "prefill_32k", "compress"),
         ("mistral-7b", "decode_32k", "decode"),
         ("mamba2-370m", "train_4k", "lm_train")]
KIND = {"memcom_train": "memcom_train", "lm_train": "lm_train",
        "compress": "prefill", "decode": "decode"}


def _record(arch, shape_name, objective, chips=None, coll=2.5e9):
    """A dry-run record as the reference writes one (``launch/dryrun.py``):
    analytic FLOPs / bytes, collectives, XLA cost and memory."""
    shape = next(s for s in JSHAPES if s.name == shape_name)
    cc = jcosts.cell_cost(jax_config(arch), shape, KIND[objective])
    rec = {"arch": arch, "shape": shape_name, "objective": objective,
           "status": "ok",
           "analytic": {"flops": cc.flops, "hbm_bytes": cc.hbm_bytes,
                        "model_flops": cc.model_flops},
           "collectives": {"total": coll},
           "collectives_full": {"total": 2 * coll},
           "xla_cost": {"flops": 1.5e12},
           "memory": {"peak_memory_in_bytes": 7e9,
                      "temp_size_in_bytes": 3e9}}
    if chips is not None:
        rec["chips"] = chips
    return rec


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
@pytest.mark.parametrize("chips", [None, 1, 4])
def test_analyze_scales_the_references_terms(cell, chips):
    rec = _record(*cell, chips=chips)
    got, want = roofline.analyze(rec), jroof.analyze(rec)
    n = chips or 1
    comp = (jroof.CHIPS * jroof.PEAK_FLOPS) / (n * roofline.PEAK_FLOPS)
    mem = (jroof.CHIPS * jroof.HBM_BW) / (n * roofline.HBM_BW)
    assert got["compute_s"] == pytest.approx(want["compute_s"] * comp,
                                             rel=1e-12)
    assert got["memory_s"] == pytest.approx(want["memory_s"] * mem,
                                            rel=1e-12)
    assert got["collective_s"] == pytest.approx(
        want["collective_s"] * jroof.LINK_BW / roofline.LINK_BW, rel=1e-12)
    terms = {k: got[f"{k}_s"] for k in ("compute", "memory", "collective")}
    assert got["dominant"] == max(terms, key=terms.get)
    assert got["note"] == roofline.NOTES[got["dominant"]]
    assert got["roofline_fraction"] == got["compute_s"] / max(terms.values())
    assert set(got) == set(want)
    for k in ("arch", "shape", "objective", "model_flops", "useful_ratio",
              "xla_flops", "peak_bytes_per_dev", "temp_bytes_per_dev"):
        assert got[k] == want[k], k


def test_constants_are_one_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) \
        == (989e12, 3.35e12, 450e9)
    assert roofline.NOTES == jroof.NOTES
    for x in (2.5, 0.0123, 4.5e-5):
        assert roofline.fmt_s(x) == jroof.fmt_s(x)


def test_collectives_fall_back_to_the_full_count():
    rec = _record(*CELLS[0])
    del rec["collectives"]
    got = roofline.analyze(rec)
    assert got["collective_s"] == 2 * 2.5e9 / roofline.LINK_BW


def test_main_prints_the_references_table(tmp_path, monkeypatch, capsys):
    """Both ``main``s over one directory of records (ok, skipped, error):
    the same header, the same rows by arch / shape / objective in the
    same order, the same skip and error lines."""
    for cell in CELLS:
        (tmp_path / f"{cell[0]}__{cell[1]}__pod16x16.json").write_text(
            json.dumps(_record(*cell, chips=1)))
    (tmp_path / "qwen2-vl-2b__long_500k__pod16x16.json").write_text(
        json.dumps({"arch": "qwen2-vl-2b", "shape": "long_500k",
                    "status": "skipped", "reason": "full attention"}))
    (tmp_path / "jamba__train_4k__pod16x16.json").write_text(json.dumps(
        {"arch": "jamba", "shape": "train_4k", "status": "error",
         "error": "OOM"}))
    (tmp_path / "other__train_4k__pod2x2.json").write_text("{}")
    outs = {}
    for name, mod in (("port", roofline), ("ref", jroof)):
        md = tmp_path / f"{name}.md"
        monkeypatch.setattr(sys, "argv", ["roofline", "--dir", str(tmp_path),
                                          "--md", str(md)])
        mod.main()
        outs[name] = capsys.readouterr().out.splitlines()
        table = md.read_text().splitlines()
        assert table == outs[name][:len(table)]
    port, ref = outs["port"], outs["ref"]
    assert len(port) == len(ref)
    assert port[:2] == ref[:2]
    rows = [i for i, ln in enumerate(ref) if ln.startswith("| ")][1:]
    assert len(rows) == len(CELLS)
    for i in rows:
        assert port[i].split(" | ")[:3] == ref[i].split(" | ")[:3]
        assert len(port[i].split(" | ")) == len(ref[i].split(" | "))
    tail = [ln for ln in ref if ln.startswith(("*", "Skipped"))]
    assert tail and tail == [ln for ln in port
                             if ln.startswith(("*", "Skipped"))]
    assert port[-2].startswith("worst roofline fraction:")
    assert port[-1].startswith("most collective-bound:")


def test_a_record_without_the_full_count_raises_as_the_references():
    """The reference reads ``collectives_full`` even where ``collectives``
    has a total (the fallback is evaluated first): a record needs both."""
    rec = _record(*CELLS[0])
    del rec["collectives_full"]
    for mod in (roofline, jroof):
        with pytest.raises(KeyError):
            mod.analyze(rec)
