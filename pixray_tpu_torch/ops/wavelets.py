"""Orthogonal wavelet filter banks as matrices (the fft drawer's dwt mode).

A copy of ``pixray_tpu/ops/wavelets.py`` (numpy only), which
``tests/test_torch_fft.py`` holds it equal to.  ``--fft_wave`` selects the
filter (default ``coif2``).  Each analysis level is ONE orthogonal N×N
matrix per axis (rows = circularly shifted low/high-pass filters,
downsampled by 2) and synthesis is its transpose: for an orthonormal
filter, circular shifts stay orthonormal for any even N, so A @ A.T == I to
machine precision and the transform is two matmuls per level.

Filters: Daubechies dbN is derived (spectral factorization of the
Daubechies polynomial); coifN comes from the published coefficient tables;
every filter is checked at build time for unit norm, sqrt(2) sum, and
orthonormality to its even shifts.
"""

from __future__ import annotations

import numpy as np

__all__ = ["wavelet_filter", "analysis_matrix", "SUPPORTED"]

SUPPORTED = "haar, db1..db20, coif1..coif5"

# Published coiflet low-pass decomposition filters (pywt ``dec_lo`` ordering).
# Source: I. Daubechies, "Ten Lectures on Wavelets" (coiflet tables), as
# normalized to sum sqrt(2) — the same constants every DWT library ships.
_COIF = {
    1: [
        -0.01565572813546454, -0.0727326195128539, 0.38486484686420286,
        0.8525720202122554, 0.3378976624578092, -0.0727326195128539,
    ],
    2: [
        -0.0007205494453645122, -0.0018232088707029932, 0.0056114348193944995,
        0.023680171946334084, -0.0594344186464569, -0.0764885990783064,
        0.41700518442169254, 0.8127236354455423, 0.3861100668211622,
        -0.06737255472196302, -0.04146493678175915, 0.016387336463522112,
    ],
    3: [
        -3.459977283621256e-05, -7.098330313814125e-05, 0.0004662169601128863,
        0.0011175187708906016, -0.0025745176887502236, -0.00900797613666158,
        0.015880544863615904, 0.03455502757306163, -0.08230192710688598,
        -0.07179982161931202, 0.42848347637761874, 0.7937772226256206,
        0.4051769024096169, -0.06112339000267287, -0.0657719112818555,
        0.023452696141836267, 0.007782596427325418, -0.003793512864491014,
    ],
    4: [
        -1.7849850030882614e-06, -3.2596802368833675e-06, 3.1229875865345646e-05,
        6.233903446100713e-05, -0.00025997455248771324, -0.0005890207562443383,
        0.0012665619292989445, 0.003751436157278457, -0.00565828668661072,
        -0.015211731527946259, 0.025082261844864097, 0.03933442712333749,
        -0.09622044203398798, -0.06662747426342504, 0.4343860564914685,
        0.782238930920499, 0.41530840703043026, -0.05607731331675481,
        -0.08126669968087875, 0.026682300156053072, 0.016068943964776348,
        -0.0073461663276420935, -0.0016294920126017326, 0.0008923136685823146,
    ],
    5: [
        -9.517657273819165e-08, -1.6744288576823017e-07, 2.0637618513646814e-06,
        3.7346551751414047e-06, -2.1315026809955787e-05, -4.134043227251251e-05,
        0.00014054114970203437, 0.00030225958181306315, -0.0006381313430451114,
        -0.0016628637020130838, 0.0024333732126576722, 0.006764185448053083,
        -0.009164231162481846, -0.01976177894257264, 0.03268357426711183,
        0.0412892087501817, -0.10557420870333893, -0.06203596396290357,
        0.4379916261718371, 0.7742896036529562, 0.4215662066908515,
        -0.05204316317624377, -0.09192001055969624, 0.02816802897093635,
        0.023408156785839195, -0.010131117519849788, -0.004159358781386048,
        0.0021782363581090178, 0.00035858968789573785, -0.00021208083980379827,
    ],
}


def _daubechies(n: int) -> np.ndarray:
    """Minimum-phase Daubechies low-pass filter with n vanishing moments
    (length 2n), derived by spectral factorization — db1 is haar."""
    if n == 1:
        return np.array([1.0, 1.0]) / np.sqrt(2.0)
    # P(y) = sum_k C(n-1+k, k) y^k ; roots in y
    coeffs = [1.0]
    for k in range(1, n):
        coeffs.append(coeffs[-1] * (n - 1 + k) / k)  # C(n-1+k, k)
    y_roots = np.roots(list(reversed(coeffs)))
    # each y root maps to a z pair via y = (2 - z - 1/z)/4; keep |z| < 1
    z_roots = []
    for y in y_roots:
        b = 4.0 * y - 2.0  # z^2 + b z + 1 = 0
        disc = np.sqrt(b * b - 4.0 + 0j)
        for z in ((-b + disc) / 2.0, (-b - disc) / 2.0):
            if abs(z) < 1.0:
                z_roots.append(z)
    # h(z) ∝ (1+z)^n * prod(z - z_i)
    h = np.array([1.0 + 0j])
    for _ in range(n):
        h = np.convolve(h, [1.0, 1.0])
    for z in z_roots:
        h = np.convolve(h, [1.0, -z])
    h = np.real(h)
    return h * (np.sqrt(2.0) / h.sum())


def wavelet_filter(name: str) -> np.ndarray:
    """Low-pass decomposition filter for a wavelet name; validated orthonormal."""
    name = name.lower().strip()
    if name == "haar":
        h = _daubechies(1)
    elif name.startswith("db") and name[2:].isdigit() and 1 <= int(name[2:]) <= 20:
        h = _daubechies(int(name[2:]))
    elif name.startswith("coif") and name[4:].isdigit() and int(name[4:]) in _COIF:
        h = np.asarray(_COIF[int(name[4:])], np.float64)
    else:
        raise ValueError(
            f"wavelet {name!r} is not supported (supported: {SUPPORTED})"
        )
    assert abs(h.sum() - np.sqrt(2.0)) < 1e-6, f"{name}: filter sum != sqrt(2)"
    assert abs((h * h).sum() - 1.0) < 1e-6, f"{name}: filter not unit-norm"
    for lag in range(2, len(h), 2):
        assert abs(np.dot(h[:-lag], h[lag:])) < 1e-6, (
            f"{name}: filter not orthonormal to its even shifts (lag {lag})"
        )
    return h


def analysis_matrix(n: int, dec_lo: np.ndarray) -> np.ndarray:
    """Orthogonal N×N one-level periodized DWT matrix.

    Rows 0..N/2-1 are circular even shifts of the low-pass filter, rows
    N/2..N-1 of the quadrature-mirror high-pass; ``A @ x`` yields
    ``[approx; detail]`` and ``A.T`` is the exact inverse.
    """
    assert n % 2 == 0, f"periodized DWT needs an even length, got {n}"
    h = np.asarray(dec_lo, np.float64)
    g = h[::-1].copy()
    g[1::2] *= -1.0  # QMF: g[k] = (-1)^k h[L-1-k]
    a = np.zeros((n, n))
    for row in range(n // 2):
        for k in range(len(h)):
            a[row, (2 * row + k) % n] += h[k]
            a[n // 2 + row, (2 * row + k) % n] += g[k]
    err = np.abs(a @ a.T - np.eye(n)).max()
    # published coif tables are truncated around 1e-8; a transcription
    # mistake shows up at 1e-3+, so 1e-6 still catches real errors
    assert err < 1e-6, f"analysis matrix not orthogonal (max err {err:.2e})"
    return a
