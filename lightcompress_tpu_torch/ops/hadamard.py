"""Hadamard matrices and transforms (port of
lightcompress_tpu/ops/hadamard.py).

- The ±1 matrices are generated, not tabulated: Sylvester doubling, Paley I
  (q prime, q = 3 mod 4), Paley II over GF(q) and GF(p^2) (q = 1 mod 4) and
  two Williamson quadruples (orders 156 and 172).  The numpy constructions
  are the JAX package's, so every matrix is its bit for bit.
- ``get_hadK(n)`` factors n = 2^a * K with the smallest constructible K
  (at most 256); ``matmul_hadU`` is x @ H_n^T / sqrt(n) along the last dim:
  a butterfly Walsh-Hadamard over the 2^a part, then the dense K x K factor.
- ``random_hadamard_matrix`` / ``random_orthogonal_matrix`` draw their signs
  or their Gaussian matrix from an explicit ``torch.Generator``; the JAX
  package draws from ``jax.random``, whose bits the port does not reproduce.

The JAX package runs with x64 off, so its float64 casts here are float32:
the port computes in f32 as it does (and keeps TF32 out of the products).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import div

# the JAX package's float64 casts land in f32 (x64 off); so do the port's
_HAD_DTYPE = torch.float32


# ---------------------------------------------------------------------------
# constructions (numpy, cached)
# ---------------------------------------------------------------------------

def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, int(n ** 0.5) + 1):
        if n % p == 0:
            return False
    return True


def _check_hadamard(H: np.ndarray) -> bool:
    n = H.shape[0]
    return bool(np.array_equal(H @ H.T, n * np.eye(n, dtype=H.dtype)))


def _paley1(q: int) -> np.ndarray:
    """Paley I: q prime, q % 4 == 3 -> H of order q + 1 (jacket form)."""
    residues = set((i * i) % q for i in range(1, q))

    def chi(x):
        x %= q
        if x == 0:
            return 0
        return 1 if x in residues else -1

    Q = np.array([[chi(j - i) for j in range(q)] for i in range(q)])
    H = np.ones((q + 1, q + 1), dtype=np.int64)
    H[1:, 0] = -1
    H[1:, 1:] = Q + np.eye(q, dtype=np.int64)
    assert _check_hadamard(H)
    return H


def _gf_p2_elements(p: int):
    """GF(p^2) as pairs (a, b) = a + b t with t^2 = the least non-residue."""
    residues = set((i * i) % p for i in range(1, p))
    nr = next(x for x in range(2, p) if x not in residues)
    elems = [(a, b) for a in range(p) for b in range(p)]

    def mul(x, y):
        a, b = x
        c, d = y
        return ((a * c + b * d * nr) % p, (a * d + b * c) % p)

    return elems, mul


def _paley_chi_table(q: int):
    """The quadratic character over GF(q), q prime or a prime square."""
    if _is_prime(q):
        residues = set((i * i) % q for i in range(1, q))

        def sub(x, y):
            return (x - y) % q

        def chi(x):
            if x % q == 0:
                return 0
            return 1 if x % q in residues else -1

        return list(range(q)), sub, chi
    p = int(round(q ** 0.5))
    assert p * p == q and _is_prime(p), f"unsupported field order {q}"
    elems, mul = _gf_p2_elements(p)
    squares = {mul(e, e) for e in elems if e != (0, 0)}

    def sub(x, y):
        return ((x[0] - y[0]) % p, (x[1] - y[1]) % p)

    def chi(x):
        if x == (0, 0):
            return 0
        return 1 if x in squares else -1

    return elems, sub, chi


def _paley2(q: int) -> np.ndarray:
    """Paley II: q = 1 mod 4 (prime or prime^2) -> H of order 2(q + 1)."""
    elems, sub, chi = _paley_chi_table(q)
    n = q + 1
    C = np.zeros((n, n), dtype=np.int64)
    C[0, 1:] = 1
    C[1:, 0] = 1
    for i, a in enumerate(elems):
        for j, b in enumerate(elems):
            if i != j:
                C[i + 1, j + 1] = chi(sub(a, b))
    P = np.array([[1, 1], [1, -1]])
    M = np.array([[1, -1], [-1, -1]])
    H = np.kron(C, P) + np.kron(np.eye(n, dtype=np.int64), M)
    assert _check_hadamard(H)
    return H


# Williamson quadruples (symmetric circulant first rows, '+-' = +1/-1) for
# the orders 156 and 172
_WILLIAMSON_ROWS = {
    39: ("+-+-++-+--+--++----------++--+--+-++-+-",
         "+-+++-++------+--+-++-+--+------++-+++-",
         "+-+-++----+++--++------++--+++----++-+-",
         "++---+-++++---+---+--+---+---++++-+---+"),
    43: ("++---++++-+--+--++--------++--+--+-++++---+",
         "++-++++++----+-+--++-++-++--+-+----++++++-+",
         "+++-+-++--+-+-++++-+----+-++++-+-+--++-+-++",
         "+---++--++++-+-+++-++--++-+++-+-++++--++---"),
}


def _williamson_K(n: int) -> np.ndarray:
    mats = []
    for r in _WILLIAMSON_ROWS[n]:
        row = np.array([1 if c == "+" else -1 for c in r], np.int64)
        assert len(row) == n, (len(row), n)
        idx = (np.arange(n)[None, :] - np.arange(n)[:, None]) % n
        mats.append(row[idx])
    a, b, c, d = mats
    H = np.block([[a, b, c, d], [-b, a, -d, c], [-c, d, a, -b],
                  [-d, -c, b, a]])
    assert _check_hadamard(H), f"Williamson rows for n={n} are not valid"
    return H


@functools.lru_cache(maxsize=None)
def hadamard_matrix_K(K: int) -> np.ndarray:
    """A ±1 Hadamard matrix of order K (int64), or ValueError."""
    if K == 1:
        return np.ones((1, 1), dtype=np.int64)
    if K & (K - 1) == 0:
        H = np.ones((1, 1), dtype=np.int64)
        while H.shape[0] < K:
            H = np.block([[H, H], [H, -H]])
        return H
    if K % 4 == 0 and K // 4 in _WILLIAMSON_ROWS:
        return _williamson_K(K // 4)
    q = K - 1
    if _is_prime(q) and q % 4 == 3:
        return _paley1(q)
    q2 = K // 2 - 1
    if K % 2 == 0:
        p = int(round(q2 ** 0.5))
        if (_is_prime(q2) and q2 % 4 == 1) or (
                p * p == q2 and _is_prime(p) and q2 % 4 == 1):
            return _paley2(q2)
    if K % 2 == 0:
        try:
            Hh = hadamard_matrix_K(K // 2)
            return np.block([[Hh, Hh], [Hh, -Hh]])
        except ValueError:
            pass
    raise ValueError(f"no generated Hadamard construction for order {K} "
                     f"(Paley I/II, Williamson, Sylvester)")


def get_hadK(n: int) -> Tuple[Optional[np.ndarray], int]:
    """(H_K as f32 numpy or None, K) for n = 2^a * K: K the odd part of n,
    doubled until constructible, at most 256."""
    K = n
    while K % 2 == 0:
        K //= 2
    while K <= min(n, 256):
        try:
            hadamard_matrix_K(K)
            break
        except ValueError:
            K *= 2
    else:
        raise ValueError(f"no Hadamard factorization for n={n} with factor "
                         f"<= 256")
    if K == 1:
        return None, 1
    return hadamard_matrix_K(K).astype(np.float32), K


@functools.lru_cache(maxsize=None)
def _hadK_tensor(K: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    return torch.from_numpy(hadamard_matrix_K(K).astype(np.float32)).to(
        device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def fwht(x: torch.Tensor) -> torch.Tensor:
    """The unnormalised Walsh-Hadamard transform over the last dim (a power
    of 2): log2 n add/sub stages, each rounded to x's dtype."""
    n = x.shape[-1]
    assert n & (n - 1) == 0, "fwht needs a power-of-2 dim"
    shape = x.shape
    x = x.reshape(-1, n)
    h = 1
    while h < n:
        x = x.reshape(-1, n // (2 * h), 2, h)
        a, b = x[:, :, 0, :], x[:, :, 1, :]
        x = torch.stack([a + b, a - b], dim=2)
        h *= 2
    return x.reshape(shape)


def _times(x: torch.Tensor, c: float) -> torch.Tensor:
    """x * c with c first rounded to x's dtype, as JAX takes a Python
    number (PyTorch would multiply a bf16 x by the f32 c)."""
    return x * torch.tensor(c, dtype=x.dtype, device=x.device)


def matmul_hadU(x: torch.Tensor, scale: Optional[float] = None
                ) -> torch.Tensor:
    """x @ H_n^T / sqrt(n) along the last dim; the non-power-of-2 factor K
    is a dense (K, K) product (f32 sums) after the butterfly."""
    n = x.shape[-1]
    hadK, K = get_hadK(n)
    if scale is None:
        scale = 1.0 / math.sqrt(n)
    if K == 1:
        return _times(fwht(x), scale)
    shape = x.shape
    xr = _times(fwht(x.reshape(-1, K, n // K)), scale)
    hk = _hadK_tensor(K, xr.dtype, xr.device)
    if xr.dtype == torch.float32:
        xr = torch.einsum("kj,bjm->bkm", hk, xr)
    else:
        # XLA's dot on a narrow dtype sums in f32 and rounds once
        xr = torch.einsum("kj,bjm->bkm", hk.float(), xr.float()).to(x.dtype)
    return xr.reshape(shape)


def random_hadamard_matrix(n: int, gen: torch.Generator,
                           device=None) -> torch.Tensor:
    """H_n diag(±1) / sqrt(n), the signs drawn from ``gen`` (f32)."""
    signs = torch.randint(0, 2, (n,), generator=gen).float() * 2 - 1
    return hadamard_from_signs(signs.to(device))


def hadamard_from_signs(signs: torch.Tensor) -> torch.Tensor:
    """The randomised Hadamard of the given ±1 signs: rows of diag(signs)
    through ``matmul_hadU``, transposed (JAX's ``random_hadamard_matrix``
    after its draw)."""
    D = torch.diag(signs.to(_HAD_DTYPE))
    return matmul_hadU(D).T.contiguous()


def random_orthogonal_matrix(n: int, gen: torch.Generator,
                             device=None) -> torch.Tensor:
    """A QR-based random orthogonal matrix from a Gaussian drawn from
    ``gen`` (f32)."""
    m = torch.randn((n, n), generator=gen, dtype=_HAD_DTYPE)
    return orthogonal_from_gaussian(m.to(device))


def orthogonal_from_gaussian(m: torch.Tensor) -> torch.Tensor:
    """Q of m = QR with R's diagonal made positive (JAX's
    ``random_orthogonal_matrix`` after its draw)."""
    q, r = torch.linalg.qr(m.to(_HAD_DTYPE))
    return q * torch.sign(torch.diagonal(r))[None, :]


def apply_had_right(W: torch.Tensor) -> torch.Tensor:
    """W @ H / sqrt(n) along the input channels (the last dim)."""
    return matmul_hadU(W.to(_HAD_DTYPE)).to(W.dtype)


def apply_had_left(W: torch.Tensor) -> torch.Tensor:
    """(H / sqrt(n)) @ W: the output channels rotated."""
    return matmul_hadU(W.T.to(_HAD_DTYPE)).T.to(W.dtype)


def apply_exact_had_to_linear(W: torch.Tensor, had_dim: int = -1,
                              output: bool = False) -> torch.Tensor:
    """Bake an exact Hadamard into a weight (out, in): ``output`` rotates
    the output channels, else the input channels; ``had_dim`` > 0 rotates
    blocks of that size (a power of 2, per head) instead of the whole
    dim."""
    Wf = W.to(_HAD_DTYPE)
    if had_dim == -1:
        return (apply_had_left(Wf) if output else
                apply_had_right(Wf)).to(W.dtype)
    assert had_dim & (had_dim - 1) == 0
    if output:
        Wt = Wf.T
        r = div(fwht(Wt.reshape(Wt.shape[0], -1, had_dim)),
                math.sqrt(had_dim))
        return r.reshape(Wt.shape).T.to(W.dtype)
    r = div(fwht(Wf.reshape(Wf.shape[0], -1, had_dim)), math.sqrt(had_dim))
    return r.reshape(Wf.shape).to(W.dtype)


def online_rotate(x: torch.Tensor, mode: str, dim: int) -> torch.Tensor:
    """The online rotation of a linear's input: ``("full", 0)`` the whole
    normalised Hadamard (``matmul_hadU``), ``("head", d)`` the normalised
    Walsh-Hadamard of each d-wide head."""
    if mode == "full":
        return matmul_hadU(x)
    shape = x.shape
    r = _times(fwht(x.reshape(*shape[:-1], shape[-1] // dim, dim)),
               1.0 / dim ** 0.5)
    return r.reshape(shape)
