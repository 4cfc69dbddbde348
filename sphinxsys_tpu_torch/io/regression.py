"""Dynamic-time-warping regression testing (the port's own copy of
sphinxsys_tpu/io/regression.py, numpy only, so that a run on a machine
without JAX is judged by the reference's criterion).

Counterpart of the reference's regression_test_tool
(dynamic_time_warping_method.hpp — windowed DTW distance between observed
time series and a committed database of converged runs;
time_average_method.hpp and ensemble_average_method.hpp — the mean /
variance databases; regression_test_base.h — XML snapshot storage).  The
XML formats are the reference's, so the committed databases under
tests/golden/ are read as they are; the distances, written bytes and
verdicts equal the JAX package's (tests/test_torch_io.py).
"""

from __future__ import annotations

import glob
import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np


def _pnorm(a, b):
    """calculatePNorm (dynamic_time_warping_method.h:55-63): |a-b| for
    scalars, Euclidean norm of the difference for vectors."""
    d = np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)
    return float(abs(d)) if d.ndim == 0 else float(np.linalg.norm(d))


def dtw_distance(series_a: np.ndarray, series_b: np.ndarray,
                 window_size: int = 5) -> float:
    """Windowed DTW distance between two series (1D scalar or (n, d)
    vector), exactly mirroring dynamic_time_warping_method.hpp:18-56
    (p-norm local distance, Sakoe-Chiba band of max(5, |len_a - len_b|))."""
    a = np.asarray(series_a, dtype=np.float64)
    b = np.asarray(series_b, dtype=np.float64)
    la, lb = len(a), len(b)
    d = np.full((la, lb), np.inf)
    d[0, 0] = _pnorm(a[0], b[0])
    for i in range(1, la):
        d[i, 0] = d[i - 1, 0] + _pnorm(a[i], b[0])
    for j in range(1, lb):
        d[0, j] = d[0, j - 1] + _pnorm(a[0], b[j])
    w = max(window_size, abs(la - lb))
    for i in range(1, la):
        for j in range(max(1, i - w), min(lb, i + w)):
            d[i, j] = _pnorm(a[i], b[j]) + min(d[i - 1, j], d[i, j - 1], d[i - 1, j - 1])
    return float(d[la - 1, lb - 1])


# ---------------------------------------------------------------------------
# Reference-compatible XML result files
# ---------------------------------------------------------------------------

def parse_value(text: str):
    """Parse a reference XML attribute value: scalar `1.25`, SimTK vector
    `~[0.45,0.0016]`, or matrix `~[[a,b],[c,d]]`."""
    t = text.strip().lstrip("~")
    if t.startswith("[["):
        rows = re.findall(r"\[([^\[\]]+)\]", t)
        return np.asarray([[float(x) for x in r.split(",")] for r in rows])
    if t.startswith("["):
        return np.asarray([float(x) for x in t[1:-1].split(",")])
    return float(t)


def format_value(v) -> str:
    """Inverse of parse_value, matching the SimTK `~[...]` convention."""
    v = np.asarray(v)
    if v.ndim == 0:
        return repr(float(v))
    if v.ndim == 1:
        return "~[" + ",".join(repr(float(x)) for x in v) + "]"
    return "~[" + ",".join(
        "[" + ",".join(repr(float(x)) for x in row) + "]" for row in v) + "]"


def read_result_xml(path: str) -> np.ndarray:
    """Read a `*_Run_N_result.xml` file -> array (n_observations,
    n_snapshots) for scalar quantities or (n_observations, n_snapshots, d)
    for vector ones."""
    root = ET.parse(path).getroot()
    result_el = root.find("Result_Element")
    rows = []
    for particle in result_el:
        snaps = sorted(particle.attrib.items(),
                       key=lambda kv: int(kv[0].rsplit("_", 1)[1]))
        rows.append([parse_value(v) for _, v in snaps])
    return np.asarray(rows)


def write_result_xml(path: str, data: np.ndarray) -> None:
    """Write observations (n_observations, n_snapshots) in the reference's
    result-XML layout."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None, :]
    lines = ['<?xml version="1.0" encoding="UTF-8" ?>', "<result>",
             "    <Snapshot_Element>",
             f'        <Snapshot number_of_snapshot_for_local_result_="{data.shape[1]}" />',
             "    </Snapshot_Element>",
             "    <Result_Element>"]
    for k, row in enumerate(data):
        attrs = " ".join(f'snapshot_{i}="{format_value(v)}"'
                         for i, v in enumerate(row))
        lines.append(f"        <Particle_{k} {attrs} />")
    lines += ["    </Result_Element>", "</result>", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def read_dtw_threshold_xml(path: str, quantity_name: str) -> np.ndarray:
    """Read `*_dtwdistance.xml` -> per-observation max allowed distance."""
    root = ET.parse(path).getroot()
    el = root[0]
    vals: Dict[int, float] = {}
    for name, v in el.attrib.items():
        m = re.match(rf"{re.escape(quantity_name)}_(\d+)$", name)
        if m:
            vals[int(m.group(1))] = float(v)
    return np.asarray([vals[k] for k in sorted(vals)])


class DTWRegressionTest:
    """testResult() semantics of the reference: the observed series must be
    within 1.01 * stored_threshold DTW distance of EVERY committed run
    (dynamic_time_warping_method.hpp:164-190)."""

    def __init__(self, db_dir: str, body_name: str, quantity_name: str):
        self.db_dir = db_dir
        self.body = body_name
        self.quantity = quantity_name
        prefix = os.path.join(db_dir, f"{body_name}_{quantity_name}")
        self.run_files = sorted(glob.glob(prefix + "_Run_*_result.xml"))
        self.threshold = read_dtw_threshold_xml(prefix + "_dtwdistance.xml",
                                                quantity_name)

    def distances(self, observed: np.ndarray) -> List[np.ndarray]:
        """Per stored run: per-observation DTW distance to `observed`
        ((n_observations, n_snapshots) or (n_snapshots,))."""
        observed = np.atleast_2d(np.asarray(observed))
        out = []
        for f in self.run_files:
            stored = read_result_xml(f)
            out.append(np.asarray([
                dtw_distance(stored[k], observed[k]) for k in range(stored.shape[0])]))
        return out

    def test(self, observed: np.ndarray, slack: float = 1.01):
        """Returns (passed, report string)."""
        dists = self.distances(observed)
        report, ok = [], True
        for f, d in zip(self.run_files, dists):
            fail = d > slack * self.threshold
            ok &= not fail.any()
            report.append(f"{os.path.basename(f)}: dtw={np.array2string(d, precision=4)} "
                          f"(limit {slack:.2f}*{self.threshold})"
                          + ("  FAIL" if fail.any() else ""))
        return ok, "\n".join(report)


# ---------------------------------------------------------------------------
# Time-averaged mean/variance regression (time_average_method.h/.hpp)
# ---------------------------------------------------------------------------

TINY = 1.0e-15


def _read_mean_variance_xml(path: str, quantity: str, mean_tag: str,
                            var_tag: str):
    """Read a `*_mean_variance.xml` file.  Returns (mean, variance) arrays;
    per-snapshot rows for the ensemble layout, single rows for the
    time-averaged one.  Shape: (n_rows, n_observations, [d])."""
    root = ET.parse(path).getroot()
    out = []
    for tag in (mean_tag, var_tag):
        el = root.find(tag)
        rows = []
        for snap in el:
            vals: Dict[int, np.ndarray] = {}
            for name, v in snap.attrib.items():
                m = re.match(rf"{re.escape(quantity)}_(\d+)$", name)
                if m:
                    vals[int(m.group(1))] = parse_value(v)
            rows.append([vals[k] for k in sorted(vals)])
        out.append(np.asarray(rows))
    return out[0], out[1]


def _write_mean_variance_xml(path: str, quantity: str, mean, variance,
                             mean_tag: str, var_tag: str, row_names):
    mean = np.asarray(mean)
    variance = np.asarray(variance)
    lines = ['<?xml version="1.0" encoding="UTF-8" ?>', "<meanvariance>"]
    for tag, data in ((mean_tag, mean), (var_tag, variance)):
        lines.append(f"    <{tag}>")
        for r, row in enumerate(data):
            attrs = " ".join(f'{quantity}_{k}="{format_value(v)}"'
                             for k, v in enumerate(row))
            lines.append(f"        <{row_names(r, tag)} {attrs} />")
        lines.append(f"    </{tag}>")
    lines += ["</meanvariance>", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def search_steady_start(result: np.ndarray) -> int:
    """searchSteadyStart (time_average_method.hpp): find the snapshot index
    from which the series is statistically steady.  result: (n_snapshots,
    n_observations, [d])."""
    result = np.asarray(result, dtype=np.float64)
    n_snap = result.shape[0]
    scale = max(1, round(n_snap / 20))
    start = 0
    for k in range(result.shape[1]):
        # the first component of observation k (first_component)
        comp = result[:, k].reshape(n_snap, -1)[:, 0]
        for l in range(n_snap - 1, 3 * scale, -1):
            v1 = np.mean(comp[l - scale + 1:l + 1])
            v2 = np.mean(comp[l - 3 * scale + 1:l - 2 * scale + 1])
            denom = abs((v1 + v2) / 2.0) + TINY
            if abs(v1 - v2) / denom > 0.1:
                start = max(start, l - scale)
                break
    return start


class TimeAverageRegressionTest:
    """Counterpart of RegressionTestTimeAverage (time_average_method.h:40):
    compares the steady-window mean and variance of a time series against a
    stored mean/variance database; reads/writes the reference's
    `*_time_averaged_mean_variance.xml` format."""

    MEAN_TAG, VAR_TAG = "MeanValue_Element", "Variance_Element"

    def __init__(self, db_dir: str, body_name: str, quantity_name: str):
        self.db_dir = db_dir
        self.body = body_name
        self.quantity = quantity_name
        self.path = os.path.join(
            db_dir, f"{body_name}_{quantity_name}_time_averaged_mean_variance.xml")

    def read_db(self):
        mean, var = _read_mean_variance_xml(self.path, self.quantity,
                                            self.MEAN_TAG, self.VAR_TAG)
        return mean[0], var[0]  # single Snapshot_MeanValue row

    def write_db(self, mean, variance):
        os.makedirs(self.db_dir, exist_ok=True)
        _write_mean_variance_xml(
            self.path, self.quantity, np.asarray(mean)[None],
            np.asarray(variance)[None], self.MEAN_TAG, self.VAR_TAG,
            lambda r, tag: "Snapshot_MeanValue" if tag == self.MEAN_TAG
            else "Snapshot_Variance")

    @staticmethod
    def steady_stats(result: np.ndarray):
        """(local_mean, local_variance, start) over the steady window.
        result: (n_snapshots, n_observations, [d])."""
        result = np.asarray(result, dtype=np.float64)
        start = search_steady_start(result)
        tail = result[start:]
        mean = tail.mean(axis=0)
        var = ((tail - mean) ** 2).mean(axis=0)
        return mean, var, start

    def test(self, result: np.ndarray, slack: float = 1.01):
        """testResult (time_average_method.hpp:137-175): per component,
        ignore if both means are tiny (<0.005); else fail when the relative
        mean deviation exceeds 10% or the new variance exceeds 1.01x the
        stored one."""
        mean_db, var_db = self.read_db()
        local_mean, local_var, start = self.steady_stats(result)
        # the reference floors the comparison variance like
        # calculateNewVariance: max(new, stored, (1% of mean)^2)
        var_new = np.maximum(local_var, (0.01 * np.abs(local_mean)) ** 2)
        tiny = (np.abs(mean_db) < 0.005) & (np.abs(local_mean) < 0.005)
        rel = np.abs((mean_db - local_mean) / (mean_db + TINY))
        fail = ~tiny & ((rel > 0.1) | (var_new > slack * var_db))
        report = (f"steady window starts at snapshot {start}; "
                  f"mean={local_mean} (db {mean_db}); "
                  f"variance={var_new} (db {var_db})")
        return not bool(np.any(fail)), report

    def update_db(self, result: np.ndarray, n_runs_so_far: int = 0):
        """generateDataBase update step: running mean over runs; variance =
        max(new-run variance, stored variance, (1% mean)^2)."""
        local_mean, local_var, _ = self.steady_stats(result)
        if n_runs_so_far == 0 or not os.path.exists(self.path):
            mean_new = local_mean
            var_new = np.maximum(local_var, (0.01 * np.abs(local_mean)) ** 2)
        else:
            mean_db, var_db = self.read_db()
            mean_new = (mean_db * n_runs_so_far + local_mean) / (n_runs_so_far + 1)
            var_new = np.maximum.reduce([
                local_var, var_db, (0.01 * np.abs(mean_new)) ** 2])
        self.write_db(mean_new, var_new)
        return mean_new, var_new


class EnsembleAverageRegressionTest:
    """Counterpart of RegressionTestEnsembleAverage
    (ensemble_average_method.h/.hpp): per-snapshot mean/variance envelope
    over the committed runs; a new curve passes when every snapshot
    satisfies ((x - mean)^2 - var) / var <= 0.01."""

    MEAN_TAG, VAR_TAG = "Mean_Element", "Variance_Element"

    def __init__(self, db_dir: str, body_name: str, quantity_name: str):
        self.db_dir = db_dir
        self.body = body_name
        self.quantity = quantity_name
        self.path = os.path.join(
            db_dir, f"{body_name}_{quantity_name}_ensemble_averaged_mean_variance.xml")

    def read_db(self):
        """-> (mean, variance): (n_snapshots, n_observations, [d])."""
        return _read_mean_variance_xml(self.path, self.quantity,
                                       self.MEAN_TAG, self.VAR_TAG)

    def write_db(self, mean, variance, snapshot_ids=None):
        os.makedirs(self.db_dir, exist_ok=True)
        mean = np.asarray(mean)
        ids = snapshot_ids or list(range(mean.shape[0]))
        _write_mean_variance_xml(
            self.path, self.quantity, mean, np.asarray(variance),
            self.MEAN_TAG, self.VAR_TAG, lambda r, tag: f"Snapshot_{ids[r]}")

    def test(self, result: np.ndarray, tolerance: float = 0.01):
        """testNewResult (ensemble_average_method.hpp:60-84).  result:
        (n_snapshots, n_observations, [d]); trailing snapshots beyond the
        DB length are ignored (the reference aligns by the shorter run)."""
        mean, var = self.read_db()
        result = np.asarray(result, dtype=np.float64)
        n = min(len(result), len(mean))
        rel = ((result[:n] - mean[:n]) ** 2 - var[:n]) / (var[:n] + TINY)
        fail = rel > tolerance
        n_fail = int(np.sum(fail))
        return n_fail == 0, (f"{n_fail} snapshot components beyond the "
                             f"ensemble envelope (max rel {np.max(rel):.4g})")

    def update_db(self, result: np.ndarray, n_runs_so_far: int = 0):
        result = np.asarray(result, dtype=np.float64)
        if n_runs_so_far == 0 or not os.path.exists(self.path):
            mean_new = result.copy()
            var_new = (0.01 * np.abs(result)) ** 2
        else:
            mean_db, var_db = self.read_db()
            n = min(len(result), len(mean_db))
            mean_new = (mean_db[:n] * n_runs_so_far + result[:n]) / (n_runs_so_far + 1)
            dev = (result[:n] - mean_new) ** 2
            var_new = np.maximum.reduce([
                dev, var_db[:n], (0.01 * np.abs(mean_new)) ** 2])
        self.write_db(mean_new, var_new)
        return mean_new, var_new
