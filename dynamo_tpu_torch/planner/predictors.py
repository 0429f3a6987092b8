"""Load predictors for the planner.

Reference analogue: components/planner/src/dynamo/planner/utils/
load_predictor.py:62-155 (constant / ARIMA / Prophet). Here: constant,
moving-average, a dependency-free AR(2)-with-trend least-squares
predictor standing in for ARIMA, and a Holt-Winters additive seasonal
predictor standing in for Prophet — pure numpy (statsmodels/prophet are
not in this image), with the season length fitted from the series'
autocorrelation when not given.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class ConstantPredictor:
    """Next load = last observed load."""

    def __init__(self, window: int = 1):
        self._last = 0.0

    def observe(self, value: float) -> None:
        self._last = float(value)

    def predict(self) -> float:
        return self._last


class MovingAveragePredictor:
    def __init__(self, window: int = 6):
        self._values: deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        self._values.append(float(value))

    def predict(self) -> float:
        return float(np.mean(self._values)) if self._values else 0.0


class ARPredictor:
    """AR(2) + linear trend via least squares over a sliding window.
    Falls back to moving average until enough history accumulates."""

    def __init__(self, window: int = 24, order: int = 2):
        self.order = order
        self._values: deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        self._values.append(float(value))

    def predict(self) -> float:
        vals = np.asarray(self._values, dtype=np.float64)
        n = len(vals)
        if n < self.order + 3:
            return float(vals.mean()) if n else 0.0
        # Design matrix: [1, t, y_{t-1}, ..., y_{t-order}]
        rows = []
        targets = []
        for t in range(self.order, n):
            rows.append([1.0, float(t)] + [vals[t - k] for k in range(1, self.order + 1)])
            targets.append(vals[t])
        coef, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(targets), rcond=None)
        nxt = [1.0, float(n)] + [vals[n - k] for k in range(1, self.order + 1)]
        pred = float(np.dot(coef, nxt))
        return max(0.0, pred)


class SeasonalPredictor:
    """Holt-Winters additive triple exponential smoothing (the seasonal
    forecaster the reference gets from Prophet/seasonal ARIMA).

    State: level ℓ, trend b, and per-phase seasonal offsets s[0..m);
    one-step forecast = ℓ + b + s[next phase]. The season length ``m``
    is either fixed or re-fitted periodically as the autocorrelation
    peak of the detrended window (diurnal load cycles discover
    themselves). Falls back to AR(2)+trend until two full seasons of
    history exist — seasonal smoothing with an unfounded m is worse than
    no seasonality."""

    def __init__(self, window: int = 288, season: int = 0,
                 alpha: float = 0.35, beta: float = 0.05, gamma: float = 0.3):
        self._values: deque[float] = deque(maxlen=window)
        self.season = season            # 0 = auto-fit
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self._fallback = ARPredictor(window=min(window, 48))
        self._fitted_m = 0
        self._since_fit = 0

    def observe(self, value: float) -> None:
        self._values.append(float(value))
        self._fallback.observe(value)
        self._since_fit += 1

    # -- season discovery --------------------------------------------------

    @staticmethod
    def _autocorr_season(vals: np.ndarray, min_m: int = 3) -> int:
        """Lag of the dominant autocorrelation peak of the detrended
        series, or 0 when nothing is convincingly periodic."""
        n = len(vals)
        if n < 4 * min_m:
            return 0
        t = np.arange(n, dtype=np.float64)
        detr = vals - np.polyval(np.polyfit(t, vals, 1), t)
        sd = detr.std()
        if sd < 1e-9:
            return 0
        detr = detr / sd
        best_m, best_r = 0, 0.25  # require a real peak, not noise
        for m in range(min_m, n // 2 + 1):
            r = float(np.mean(detr[m:] * detr[:-m]))
            if r > best_r:
                best_m, best_r = m, r
        return best_m

    def _season_len(self, vals: np.ndarray) -> int:
        if self.season > 0:
            return self.season
        if self._fitted_m == 0 or self._since_fit >= max(16, self._fitted_m):
            self._fitted_m = self._autocorr_season(vals)
            self._since_fit = 0
        return self._fitted_m

    def predict(self) -> float:
        vals = np.asarray(self._values, dtype=np.float64)
        n = len(vals)
        m = self._season_len(vals) if n else 0
        if m == 0 or n < 2 * m:
            return self._fallback.predict()
        # Init from the first two seasons, then smooth through the rest.
        level = float(vals[:m].mean())
        trend = float((vals[m : 2 * m].mean() - vals[:m].mean()) / m)
        seasonal = (vals[:m] - level).tolist()
        for i in range(m, n):
            s = seasonal[i % m]
            prev_level = level
            level = self.alpha * (vals[i] - s) + (1 - self.alpha) * (level + trend)
            trend = self.beta * (level - prev_level) + (1 - self.beta) * trend
            seasonal[i % m] = self.gamma * (vals[i] - level) + (1 - self.gamma) * s
        return max(0.0, level + trend + seasonal[n % m])


PREDICTORS = {
    "constant": ConstantPredictor,
    "moving-average": MovingAveragePredictor,
    "ar": ARPredictor,
    "seasonal": SeasonalPredictor,
}


def make_predictor(kind: str, window: int = 24, **kw):
    try:
        cls = PREDICTORS[kind]
    except KeyError:
        raise ValueError(f"unknown predictor {kind!r}; have {sorted(PREDICTORS)}") from None
    if kind == "constant":
        return cls(**kw)
    if kind == "seasonal":
        return cls(window=max(window, 96), **kw)
    return cls(window=window, **kw)  # extras raise TypeError, never vanish
