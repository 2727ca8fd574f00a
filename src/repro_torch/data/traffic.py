"""Synthetic Traffic-like dataset (paper Sec. V-A substitute).

Counterpart of ``repro/data/traffic.py``, numpy only: the same seed gives
byte-equal arrays in both packages.

The paper benchmarks on the LSTNet Traffic dataset [21]: road-occupancy
rates ([0,1]) from 862 California sensors, hourly, 2015-2016 (~17544 steps).
That data is not redistributable, so we generate a statistically matched
surrogate: per-sensor mixtures of daily (24h) and weekly (168h) harmonics
with rush-hour asymmetry, AR(1) noise, and occasional incident spikes,
clipped to [0, 1].  The *relative* model ordering of
Table I (KAN < MLP error at fewer params) is reproduced on this surrogate;
absolute MSEs necessarily differ from the paper and are reported as such
(DESIGN.md Sec. 8).

Following [20], windows of 72 hours predict the next 96 hours,
channel-independent (each sensor contributes its own window sample).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

HOURS_DAY = 24
HOURS_WEEK = 168


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    n_sensors: int = 96          # full dataset: 862; subset for CPU budget
    n_hours: int = 4096          # full: 17544
    lookback: int = 72           # paper: 3 days in
    horizon: int = 96            # paper: 4 days out
    stride: int = 24             # window stride (one per day per sensor)
    seed: int = 0
    splits: Tuple[float, float, float] = (0.7, 0.2, 0.1)  # paper ratio


def generate_series(cfg: TrafficConfig) -> np.ndarray:
    """(n_hours, n_sensors) occupancy in [0, 1]."""
    rng = np.random.default_rng(cfg.seed)
    t = np.arange(cfg.n_hours)[:, None].astype(np.float64)

    base = rng.uniform(0.03, 0.15, cfg.n_sensors)          # off-peak level
    amp_d = rng.uniform(0.1, 0.45, cfg.n_sensors)          # daily swing
    amp_w = rng.uniform(0.02, 0.12, cfg.n_sensors)         # weekly swing
    phase = rng.uniform(0, 2 * np.pi, cfg.n_sensors)
    sharp = rng.uniform(1.5, 4.0, cfg.n_sensors)           # rush-hour peaking

    day = np.sin(2 * np.pi * t / HOURS_DAY + phase)
    # rush-hour asymmetry: sharpen positive lobes
    day = np.sign(day) * np.abs(day) ** sharp
    week = np.cos(2 * np.pi * t / HOURS_WEEK + 0.5 * phase)
    x = base + amp_d * np.clip(day, 0, None) + amp_w * week

    # AR(1) noise + sparse incident spikes
    noise = np.zeros_like(x)
    eps = rng.normal(0, 0.012, x.shape)
    for i in range(1, cfg.n_hours):
        noise[i] = 0.85 * noise[i - 1] + eps[i]
    spikes = (rng.random(x.shape) < 0.002) * rng.uniform(0.2, 0.5, x.shape)
    return np.clip(x + noise + spikes, 0.0, 1.0).astype(np.float32)


def make_windows(series: np.ndarray, cfg: TrafficConfig):
    """Channel-independent sliding windows: X (N, lookback), Y (N, horizon)."""
    T, S = series.shape
    starts = np.arange(0, T - cfg.lookback - cfg.horizon + 1, cfg.stride)
    xs, ys = [], []
    for s0 in starts:
        xs.append(series[s0:s0 + cfg.lookback, :].T)              # (S, 72)
        ys.append(series[s0 + cfg.lookback:
                         s0 + cfg.lookback + cfg.horizon, :].T)   # (S, 96)
    x = np.concatenate(xs, 0)
    y = np.concatenate(ys, 0)
    return x, y


def load_traffic(cfg: TrafficConfig = TrafficConfig()) -> Dict[str, np.ndarray]:
    """{'train_x', 'train_y', 'val_x', ..., 'test_y'}, split chronologically
    7:2:1 like the paper (split on window start time to avoid leakage)."""
    series = generate_series(cfg)
    x, y = make_windows(series, cfg)
    n = x.shape[0]
    # windows were emitted start-time-major (per start, all sensors), so a
    # prefix/suffix split is chronological
    n_tr = int(cfg.splits[0] * n)
    n_va = int(cfg.splits[1] * n)
    out = {
        "train_x": x[:n_tr], "train_y": y[:n_tr],
        "val_x": x[n_tr:n_tr + n_va], "val_y": y[n_tr:n_tr + n_va],
        "test_x": x[n_tr + n_va:], "test_y": y[n_tr + n_va:],
    }
    return out


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0,
            shuffle: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    idx = np.arange(x.shape[0])
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        sel = idx[i:i + batch_size]
        yield x[sel], y[sel]


# Error metrics of Table I.

def mse(pred: np.ndarray, true: np.ndarray) -> float:
    return float(np.mean((pred - true) ** 2))


def mae(pred: np.ndarray, true: np.ndarray) -> float:
    return float(np.mean(np.abs(pred - true)))


def rse(pred: np.ndarray, true: np.ndarray) -> float:
    """Root Relative Squared Error (LSTNet convention [21])."""
    num = np.sum((pred - true) ** 2)
    den = np.sum((true - true.mean()) ** 2)
    return float(np.sqrt(num / den))
