"""The kernel build cache keys on everything a build reads: a source, the
headers beside it and the nvcc flags (``repro_torch.kernels.build``). No
nvcc is needed: the digest is a function of its own."""
from repro_torch.kernels import build


def test_digest_changes_with_a_header(tmp_path):
    source = tmp_path / "k.cu"
    source.write_text('#include "rows.cuh"\n')
    header = tmp_path / "rows.cuh"
    header.write_text("// v1\n")
    before = build.source_digest(source)
    assert build.source_digest(source) == before  # deterministic
    header.write_text("// v2\n")
    assert build.source_digest(source) != before
    header.write_text("// v1\n")
    assert build.source_digest(source) == before
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert build.source_digest(source) != before


def test_digest_changes_with_the_source_and_the_flags(tmp_path,
                                                      monkeypatch):
    source = tmp_path / "k.cu"
    source.write_text("// a\n")
    before = build.source_digest(source)
    source.write_text("// b\n")
    after = build.source_digest(source)
    assert after != before
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.source_digest(source) != after


def test_both_kernel_sources_share_the_row_header():
    """Every kernel library (the fused K1–K4, the streamed K5–K8 and the
    per-bucket tile K9/K10) includes the one row header, and each has a
    build key of its own."""
    csrc = build._CSRC
    header = (csrc / "sketch_rows.cuh").read_text()
    assert "mg_fold_row" in header and "bm_fold_row" in header
    names = ("mg_fused", "mg_stream", "mg_tile")
    assert sorted(p.stem for p in csrc.glob("*.cu")) == sorted(names)
    for name in names:
        source = (csrc / f"{name}.cu").read_text()
        assert '#include "sketch_rows.cuh"' in source
    assert len({build.source_digest(csrc / f"{name}.cu")
                for name in names}) == len(names)


def test_tile_kernel_digest_covers_its_source_and_the_row_header(tmp_path):
    """The per-bucket library is rebuilt when mg_tile.cu or either header
    it includes (the fold bodies, the shared-memory stage) changes: its
    key reads all three."""
    headers = ("sketch_rows.cuh", "row_stage.cuh")
    for name in ("mg_tile.cu",) + headers:
        (tmp_path / name).write_bytes((build._CSRC / name).read_bytes())
    source = tmp_path / "mg_tile.cu"
    assert build.source_digest(source) == build.source_digest(
        build._CSRC / "mg_tile.cu")
    for name in headers:
        before = build.source_digest(source)
        header = tmp_path / name
        header.write_text(header.read_text() + "// edited\n")
        assert build.source_digest(source) != before


def test_tile_and_fused_kernels_share_the_stage_header():
    """K9/K10 (mg_tile.cu) and K3 (mg_fused.cu) fold from one
    shared-memory stage, row_stage.cuh; the streamed kernels do not use
    it."""
    csrc = build._CSRC
    stage = (csrc / "row_stage.cuh").read_text()
    assert "fold_staged" in stage and "stage_chunk" in stage
    for name, uses in (("mg_tile", True), ("mg_fused", True),
                       ("mg_stream", False)):
        source = (csrc / f"{name}.cu").read_text()
        assert ('#include "row_stage.cuh"' in source) == uses, name
        assert ("fold_staged<" in source) == uses, name
