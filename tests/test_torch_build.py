"""The CUDA build helper on the CPU: no ``nvcc`` is needed to read back a
library built earlier, with the ptxas report kept beside it."""
from repro_torch.kernels import _build


def test_an_earlier_build_keeps_its_ptxas_report(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    target = _build._target("rglru_scan")
    assert target.parent == tmp_path and target.name.startswith("rglru_scan-")
    target.write_bytes(b"")
    report = "ptxas info    : Used 62 registers, used 0 barriers, 32800 bytes smem\n"
    target.with_suffix(".log").write_text(report)
    assert _build.build("rglru_scan") == {"rglru_scan": target}
    assert _build.BUILD_LOGS == {"rglru_scan": report}


def test_an_edited_source_gets_a_new_target(tmp_path, monkeypatch):
    """The library's name carries a hash of its source and the flags, so an
    edited source is built anew, never loaded stale."""
    src = (_build.CSRC / "rglru_scan.cu").read_text()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "rglru_scan.cu").write_text(src)
    before = _build._target("rglru_scan")
    (tmp_path / "rglru_scan.cu").write_text(src + "\n// edited\n")
    assert _build._target("rglru_scan") != before
