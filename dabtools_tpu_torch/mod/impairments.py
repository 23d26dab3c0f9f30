"""Channel impairments for robustness testing (SURVEY.md s4 item 1).

All operate on complex baseband at 2.048 Msps and are deterministic given a
``numpy.random.Generator``.
"""

from __future__ import annotations

import numpy as np

from dabtools_tpu_torch.constants import SAMPLE_RATE


def awgn(x: np.ndarray, snr_db: float,
         rng: np.random.Generator) -> np.ndarray:
    """Add complex AWGN at the given SNR relative to the mean signal power."""
    power = float(np.mean(np.abs(x) ** 2))
    noise_power = power / (10 ** (snr_db / 10))
    noise = rng.normal(scale=np.sqrt(noise_power / 2), size=(x.size, 2))
    return (x + noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)


def carrier_offset(x: np.ndarray, cfo_hz: float,
                   sample_rate: float = SAMPLE_RATE,
                   start_sample: int = 0) -> np.ndarray:
    """Apply a carrier-frequency offset (rotates at cfo_hz).

    ``start_sample`` keeps the rotation phase-continuous when a long
    stream is processed in chunks (pass the running sample count)."""
    n = np.arange(start_sample, start_sample + x.size, dtype=np.float64)
    return (x * np.exp(2j * np.pi * cfo_hz * n / sample_rate)).astype(
        np.complex64)


def timing_offset(x: np.ndarray, samples: int) -> np.ndarray:
    """Delay the stream by ``samples`` (prepends zeros)."""
    if samples < 0:
        return x[-samples:]
    return np.concatenate([np.zeros(samples, dtype=np.complex64), x])


def amplitude(x: np.ndarray, gain: float) -> np.ndarray:
    return (x * gain).astype(np.complex64)


# --------------------------------------------------------------------------
# Multipath / SFN channel model (tapped delay line, optional Rayleigh fading)
#
# No counterpart exists in the reference (its validation was "point at a
# live broadcast", SURVEY.md s4); this synthesizes the propagation
# conditions DAB was designed for — frequency-selective urban multipath
# (COST 207 TU6) and single-frequency-network echoes inside the guard
# interval — so the receiver's robustness is testable without an antenna.

# COST 207 "Typical Urban, 6 taps": (excess delay us, mean power dB).
TU6 = ((0.0, -3.0), (0.2, 0.0), (0.5, -2.0),
       (1.6, -6.0), (2.3, -8.0), (5.0, -10.0))
# COST 207 "Rural Area, 4 taps" — short delay spread, strong LOS.
RA4 = ((0.0, 0.0), (0.2, -2.0), (0.4, -10.0), (0.6, -20.0))

PROFILES = {"tu6": TU6, "ra4": RA4}


def _frac_delay_fir(frac: float, n_taps: int = 65) -> np.ndarray:
    """Windowed-sinc fractional-delay FIR (bulk delay (n_taps-1)/2 + frac).

    A Blackman-windowed sinc is flat to <0.1 dB over the occupied DAB
    band (|f| <= 0.375 fs) at 65 taps; the constant bulk group delay is
    common to every tap so it acts as a harmless timing offset.
    """
    n = np.arange(n_taps, dtype=np.float64)
    h = np.sinc(n - (n_taps - 1) / 2 - frac) * np.blackman(n_taps)
    return h / np.sum(h)


class MultipathChannel:
    """Streaming tapped-delay-line channel.

    ``profile``: iterable of (delay_us, power_db) taps, normalized to unit
    average power.  ``doppler_hz`` = 0 gives a static frequency-selective
    channel (one deterministic random phase per tap); > 0 gives per-tap
    Rayleigh fading via a Jakes sum-of-sinusoids process, evaluated at a
    decimated rate and linearly interpolated (the Doppler rate is ~5
    orders of magnitude below the sample rate).

    Calls are chunk-wise streaming: filter history and the fading clock
    carry across calls, so feeding one long array or many chunks yields
    identical output.
    """

    def __init__(self, profile=TU6, doppler_hz: float = 0.0,
                 rng: np.random.Generator | None = None,
                 sample_rate: float = SAMPLE_RATE,
                 n_sinusoids: int = 16, fading_decim: int = 256,
                 n_taps: int = 65):
        rng = rng if rng is not None else np.random.default_rng(0)
        profile = tuple(profile)
        amps = np.array([10.0 ** (p / 20.0) for _, p in profile])
        amps /= np.sqrt(np.sum(amps ** 2))          # unit mean channel power
        delays = np.array([d * 1e-6 * sample_rate for d, _ in profile])
        self._fs = float(sample_rate)
        self._doppler = float(doppler_hz)
        self._decim = int(fading_decim)
        L = int(np.ceil(delays.max())) + n_taps     # composite FIR length
        # Per-tap FIR positioned at its (integer + fractional) delay.
        self._tap_firs = np.zeros((len(profile), L), dtype=np.complex128)
        phases = rng.uniform(0.0, 2.0 * np.pi, size=len(profile))
        for m, (d, a) in enumerate(zip(delays, amps)):
            k = int(np.floor(d))
            fir = _frac_delay_fir(d - k, n_taps) * a
            self._tap_firs[m, k:k + n_taps] = fir * np.exp(1j * phases[m])
        if self._doppler > 0.0:
            # Jakes: alpha_k spread over the circle with a random rotation,
            # independent per tap; E|g|^2 = 1.
            k = np.arange(n_sinusoids)
            self._alpha = ((2.0 * np.pi * (k + 0.5) / n_sinusoids)[None, :]
                           + rng.uniform(0, 2 * np.pi,
                                         (len(profile), 1)))
            self._phi = rng.uniform(0, 2 * np.pi,
                                    (len(profile), n_sinusoids))
            # With fading, the static per-tap phase is redundant.
            self._tap_firs *= np.exp(-1j * phases)[:, None]
        else:
            self._h = self._tap_firs.sum(axis=0)    # one composite FIR
        self._hist = np.zeros(L - 1, dtype=np.complex64)
        self._t = 0                                  # absolute sample clock

    def _fading(self, n: int) -> np.ndarray:
        """(n_tap, n) unit-power complex gains for samples [_t, _t + n)."""
        d = self._decim
        grid = np.arange(self._t - self._t % d,
                         self._t + n + d, d, dtype=np.float64)
        t_sec = grid[None, :, None] / self._fs       # (1, G, 1)
        w = 2.0 * np.pi * self._doppler * np.cos(self._alpha)  # (M, K)
        g = np.exp(1j * (w[:, None, :] * t_sec + self._phi[:, None, :]))
        g = g.mean(axis=-1) * np.sqrt(g.shape[-1])   # (M, G), E|g|^2 = 1
        ts = np.arange(self._t, self._t + n, dtype=np.float64)
        re = np.stack([np.interp(ts, grid, gm.real) for gm in g])
        im = np.stack([np.interp(ts, grid, gm.imag) for gm in g])
        return re + 1j * im

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.complex64)
        xf = np.concatenate([self._hist, x])
        nh = self._hist.size
        if self._doppler > 0.0:
            g = self._fading(x.size)
            y = np.zeros(x.size, dtype=np.complex128)
            for m in range(self._tap_firs.shape[0]):
                conv = np.convolve(xf, self._tap_firs[m])
                y += g[m] * conv[nh:nh + x.size]
        else:
            y = np.convolve(xf, self._h)[nh:nh + x.size]
        self._hist = xf[-nh:] if nh else self._hist
        self._t += x.size
        return y.astype(np.complex64)


def multipath(x: np.ndarray, profile=TU6, doppler_hz: float = 0.0,
              rng: np.random.Generator | None = None,
              sample_rate: float = SAMPLE_RATE) -> np.ndarray:
    """One-shot tapped-delay-line channel (see :class:`MultipathChannel`)."""
    return MultipathChannel(profile, doppler_hz, rng,
                            sample_rate=sample_rate)(x)


def sfn_echo(x: np.ndarray, delay_us: float, gain_db: float,
             phase: float = 0.0,
             sample_rate: float = SAMPLE_RATE) -> np.ndarray:
    """Add a single-frequency-network echo: a second transmitter's copy of
    the same signal ``delay_us`` later at ``gain_db`` relative power.  DAB
    tolerates any echo inside the guard interval (246 us in Mode I)."""
    d = delay_us * 1e-6 * sample_rate
    k = int(np.floor(d))
    fir = _frac_delay_fir(d - k) * 10.0 ** (gain_db / 20.0)
    bulk = (fir.size - 1) // 2
    conv = np.convolve(np.asarray(x, np.complex128), fir)  # delay bulk+frac
    full = np.concatenate([np.zeros(k, np.complex128), conv])
    e = full[bulk:bulk + x.size]                     # net delay k + frac
    return (x + e * np.exp(1j * phase)).astype(np.complex64)


def quantize_u8(x: np.ndarray, scale: float = 64.0) -> np.ndarray:
    """Round-trip through RTL-SDR-style unsigned 8-bit IQ (offset 128)."""
    iq = np.empty(2 * x.size, dtype=np.float32)
    iq[0::2], iq[1::2] = x.real, x.imag
    u8 = np.clip(np.round(iq * scale + 128.0), 0, 255).astype(np.uint8)
    return u8


def u8_to_complex(u8: np.ndarray, scale: float = 64.0) -> np.ndarray:
    # One float32 buffer of (u8 - 128) / scale, its interleaved I/Q pairs read
    # as complex64: the bits of converting I and Q apart, without complex128
    # temporaries.  ``f /= scale`` promotes ``scale`` as ``f / scale`` does
    # (in NumPy 2 a NumPy float64 divides in float64, rounded once to float32).
    if u8.size % 2:
        raise ValueError(
            f"{u8.size} bytes: interleaved I/Q needs an even count")
    f = np.subtract(u8, np.float32(128.0), dtype=np.float32)
    f /= scale
    return f.view(np.complex64)
