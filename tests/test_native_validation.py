"""Tests for the native VTS codec and the extended validation components."""

import numpy as np
import pytest

from anap3_tpu.models.params import Metrics
from anap3_tpu.analysis import validation as V
from anap3_tpu.utils import vts
from anap3_tpu.utils.native import vts_codec


class TestNativeCodec:
    def test_roundtrip_and_cross_compat(self):
        codec = vts_codec()
        if codec is None:
            pytest.skip("native toolchain unavailable")
        rng = np.random.default_rng(0)
        data = rng.normal(size=40000).tobytes()
        enc = codec.encode(data)
        assert codec.decode(enc) == data
        # python reader consumes native-encoded payloads
        arr = vts._decode_inline_binary(enc, np.float64)
        np.testing.assert_array_equal(arr, np.frombuffer(data))

    def test_reads_reference_fixture(self, repo_root):
        grid = vts.read_vts(repo_root / "data/validation/fv/Re100/solution.vts")
        assert grid.point_data["u"].shape == (128 * 128,)
        assert abs(grid.point_data["u"]).max() < 1.0

    def test_write_read_uses_native_path(self, tmp_path):
        pts = np.random.default_rng(1).normal(size=(64, 3))
        vts.write_vts(tmp_path / "t.vts", pts,
                      {"u": pts[:, 0].copy()}, {"Re": np.array([7])},
                      (8, 8, 1))
        g = vts.read_vts(tmp_path / "t.vts")
        np.testing.assert_allclose(g.points, pts)
        np.testing.assert_allclose(g.point_data["u"], pts[:, 0])


class TestSaadTable:
    def test_rows_for_re1000(self, repo_root):
        m = Metrics(final_energy=0.0226, final_enstrophy=4.82,
                    final_palinstrophy=8270.0)
        rows = V.saad_quantities_rows(m, 1000, "96x96", base_dir=repo_root)
        assert rows is not None and len(rows) == 3
        energy_row = rows[0]
        assert energy_row["Quantity"] == "Energy"
        assert float(energy_row["Error (%)"]) < 1.0

    def test_missing_re_returns_none(self, repo_root):
        m = Metrics()
        assert V.saad_quantities_rows(m, 777, "8x8", base_dir=repo_root) is None


class TestErrorHeatmaps:
    def test_heatmaps_written(self, tmp_path):
        n = 16
        x = np.repeat(np.linspace(0.01, 0.99, n), n)
        y = np.tile(np.linspace(0.01, 0.99, n), n)
        ref_u = np.sin(np.pi * x)
        ref_v = np.cos(np.pi * y)
        cur_u = ref_u + 0.01
        cur_v = ref_v - 0.01
        paths = V.save_validation_error_heatmaps(
            x, y, ref_u, ref_v, cur_u, cur_v, 100, "testsolver",
            output_dir=tmp_path)
        assert len(paths) == 2
        assert all(p.exists() for p in paths)


class TestVtsFormats:
    def test_reads_ascii_format(self, tmp_path):
        """Hand-written ascii .vts files load through the same reader."""
        n = 4
        xs = np.linspace(0, 1, n)
        pts = "\n".join(f"{x} {y} 0.0" for y in xs for x in xs)
        vals = " ".join(str(float(i)) for i in range(n * n))
        (tmp_path / "a.vts").write_text(f'''<?xml version="1.0"?>
<VTKFile type="StructuredGrid" version="0.1" byte_order="LittleEndian">
  <StructuredGrid WholeExtent="0 {n-1} 0 {n-1} 0 0">
  <Piece Extent="0 {n-1} 0 {n-1} 0 0">
    <PointData>
      <DataArray type="Float64" Name="u" format="ascii">{vals}</DataArray>
    </PointData>
    <Points>
      <DataArray type="Float64" Name="Points" NumberOfComponents="3" format="ascii">
{pts}
      </DataArray>
    </Points>
  </Piece>
  </StructuredGrid>
</VTKFile>''')
        g = vts.read_vts(tmp_path / "a.vts")
        assert g.point_data["u"].shape == (n * n,)
        np.testing.assert_allclose(g.point_data["u"],
                                   np.arange(n * n, dtype=float))
        assert g.dimensions == (n, n, 1)


class TestDivergedL2:
    def test_all_nan_solution_reports_nan_not_zero(self, repo_root):
        """A diverged (all-NaN) field must NOT score a perfect 0.0 L2."""
        nan_eval = lambda x, y: (np.full_like(x, np.nan),
                                 np.full_like(x, np.nan))
        errs = V.compute_l2_errors_vs_reference(
            nan_eval, Re=1000.0, base_dir=repo_root)
        assert errs, "reference fixture missing"
        assert all(np.isnan(v) for v in errs.values()), errs

    def test_partial_nan_still_masked(self, repo_root):
        """Isolated NaN points stay masked (per-lane isolation semantics)."""
        def ev(x, y):
            u = np.zeros_like(x)
            v = np.zeros_like(x)
            u[0] = np.nan
            return u, v
        errs = V.compute_l2_errors_vs_reference(
            ev, Re=1000.0, base_dir=repo_root)
        assert errs and all(np.isfinite(v) for v in errs.values())
