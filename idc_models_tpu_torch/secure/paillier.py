"""Paillier additively-homomorphic encryption (host-side parity mode).

A copy of ``idc_models_tpu/secure/paillier.py`` (standard library only):
the port keeps its own copy rather than importing the JAX package.

The reference encrypts weights with the `phe` library
(secure_fed_model.py:32,79,109-129): `generate_paillier_keypair()`, scalar
`encrypt`/`decrypt`, ciphertext addition and plaintext-scalar
multiplication — which is what makes the server's elementwise *mean* work
in ciphertext space (homomorphic add + multiply-by-1/K,
secure_fed_model.py:160-168). `phe` is not available in this environment,
so this module is a from-scratch implementation of the same surface:

- `generate_paillier_keypair(n_length)` -> (PaillierPublicKey, PaillierPrivateKey)
- `pub.encrypt(float) -> EncryptedNumber`, `priv.decrypt(EncryptedNumber) -> float`
- `EncryptedNumber + EncryptedNumber`, `EncryptedNumber * float`,
  `EncryptedNumber / int`

Floats use base-2 mantissa/exponent encoding (like phe's EncodedNumber):
value = mantissa * 2**exponent with mantissa taken mod n (negatives wrap).
Ciphertext addition aligns exponents by scaling the higher-exponent
operand; scalar multiplication raises the ciphertext to the scalar's
mantissa and adds exponents. This is bignum math on the host CPU — it does
not (and should not) touch the card; the fast path is `secure.masking`.
Keys default to 2048 bits; tests use smaller keys for
speed.

Paillier with g = n + 1: enc(m) = (1 + n*m) * r^n mod n^2;
dec(c) = L(c^lambda mod n^2) * mu mod n, L(x) = (x - 1) / n.
"""

from __future__ import annotations

import dataclasses
import math
import secrets

_MANTISSA_BITS = 53  # float64 precision


def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    while True:
        p = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(p):
            return p


@dataclasses.dataclass(frozen=True)
class PaillierPublicKey:
    n: int

    @property
    def nsquare(self) -> int:
        return self.n * self.n

    def raw_encrypt(self, m: int) -> int:
        """Encrypt an integer already reduced mod n."""
        n, n2 = self.n, self.nsquare
        while True:
            r = secrets.randbelow(n)
            if r > 0 and math.gcd(r, n) == 1:
                break
        return ((1 + n * m) % n2) * pow(r, n, n2) % n2

    def encrypt(self, value: float | int) -> "EncryptedNumber":
        mantissa, exponent = _encode(value)
        return EncryptedNumber(self, self.raw_encrypt(mantissa % self.n),
                               exponent)


@dataclasses.dataclass(frozen=True)
class PaillierPrivateKey:
    public_key: PaillierPublicKey
    p: int
    q: int

    @property
    def _lambda(self) -> int:
        return math.lcm(self.p - 1, self.q - 1)

    @property
    def _mu(self) -> int:
        n = self.public_key.n
        lx = (pow(1 + n, self._lambda, n * n) - 1) // n
        return pow(lx, -1, n)

    def raw_decrypt(self, ciphertext: int) -> int:
        n = self.public_key.n
        lx = (pow(ciphertext, self._lambda, n * n) - 1) // n
        return (lx * self._mu) % n

    def decrypt(self, enc: "EncryptedNumber") -> float:
        m = self.raw_decrypt(enc.ciphertext)
        n = self.public_key.n
        if m > n // 2:  # negative wraparound
            m -= n
        return _decode(m, enc.exponent)


def generate_paillier_keypair(n_length: int = 2048
                              ) -> tuple[PaillierPublicKey, PaillierPrivateKey]:
    """Keypair generation (parity: phe.generate_paillier_keypair,
    secure_fed_model.py:79)."""
    while True:
        p = _random_prime(n_length // 2)
        q = _random_prime(n_length // 2)
        if p != q:
            break
    pub = PaillierPublicKey(p * q)
    return pub, PaillierPrivateKey(pub, p, q)


def _encode(value: float | int) -> tuple[int, int]:
    """value -> (mantissa, exponent) with value ~= mantissa * 2**exponent."""
    if value == 0:
        return 0, 0
    frac, exp = math.frexp(float(value))
    mantissa = int(round(frac * (1 << _MANTISSA_BITS)))
    return mantissa, exp - _MANTISSA_BITS


def _decode(mantissa: int, exponent: int) -> float:
    return math.ldexp(mantissa, exponent)


@dataclasses.dataclass(frozen=True)
class EncryptedNumber:
    """A Paillier ciphertext with a fixed-point exponent.

    Supports the operations the reference's server applies to encrypted
    tensors: ciphertext + ciphertext, ciphertext * scalar, ciphertext /
    scalar (secure_fed_model.py:160-168 computes mean via add and divide).
    """

    public_key: PaillierPublicKey
    ciphertext: int
    exponent: int
    # upper bound on bits of |plaintext mantissa|, tracked through every
    # homomorphic op: sign decode (negative wraps above n/2) breaks as
    # soon as a mantissa reaches n/2, silently, so each op budgets its
    # growth and _scaled_to / __mul__ raise before wrap can happen
    mantissa_bits: int = _MANTISSA_BITS

    def _check_bits(self, bits: int, what: str) -> int:
        if bits > self.public_key.n.bit_length() - 2:
            raise ValueError(
                f"{what} would overflow the "
                f"{self.public_key.n.bit_length()}-bit modulus (mantissa "
                f"bound 2^{bits} reaches n/2 and would wrap, decrypting "
                f"to garbage — use a larger key or rescale operands)")
        return bits

    def _scaled_to(self, exponent: int) -> "EncryptedNumber":
        """Re-express at a smaller exponent (multiply mantissa by 2^diff).

        Guarded against encoding overflow (mirroring phe): easiest to hit
        by adding operands of wildly different magnitudes under a small
        (e.g. 512-bit) key.
        """
        if exponent > self.exponent:
            raise ValueError("can only decrease exponent")
        diff = self.exponent - exponent
        bits = self._check_bits(self.mantissa_bits + diff,
                                f"exponent alignment by 2^{diff}")
        factor = 1 << diff
        c = pow(self.ciphertext, factor, self.public_key.nsquare)
        return EncryptedNumber(self.public_key, c, exponent, bits)

    def __add__(self, other):
        if isinstance(other, EncryptedNumber):
            if other.public_key is not self.public_key and \
                    other.public_key != self.public_key:
                raise ValueError("mismatched public keys")
            exp = min(self.exponent, other.exponent)
            a = self._scaled_to(exp)
            b = other._scaled_to(exp)
            bits = self._check_bits(
                max(a.mantissa_bits, b.mantissa_bits) + 1, "addition")
            c = (a.ciphertext * b.ciphertext) % self.public_key.nsquare
            return EncryptedNumber(self.public_key, c, exp, bits)
        return self + self.public_key.encrypt(other)

    __radd__ = __add__

    def __mul__(self, scalar: float | int) -> "EncryptedNumber":
        mantissa, exp = _encode(scalar)
        bits = self._check_bits(self.mantissa_bits + _MANTISSA_BITS,
                                "scalar multiplication")
        n, n2 = self.public_key.n, self.public_key.nsquare
        c = pow(self.ciphertext, mantissa % n, n2)
        return EncryptedNumber(self.public_key, c, self.exponent + exp, bits)

    __rmul__ = __mul__

    def __truediv__(self, scalar: float | int) -> "EncryptedNumber":
        return self * (1.0 / scalar)
