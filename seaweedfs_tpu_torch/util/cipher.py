"""Chunk encryption: AES-256-GCM (reference: weed/util/cipher.go).

Each chunk gets a fresh random key; the key lives in filer metadata
(FileChunk.cipher_key), never on the volume server. The nonce is
prepended to the ciphertext exactly like the reference's Seal with a
random nonce prefix.
"""

from __future__ import annotations

import os

KEY_SIZE = 32
NONCE_SIZE = 12


class CipherError(RuntimeError):
    # RuntimeError subclass so the data-plane handlers' generic
    # `except RuntimeError` (filer do_POST, chunk readers) map a
    # cipher failure to a JSON 500, never an escaped exception
    pass


def _aesgcm():
    """Deferred dependency: images without the cryptography package
    must still import the filer stack (cipher=False is the default and
    never reaches this) — an actual encrypted read/write on such an
    image raises CipherError at call time instead of breaking every
    filer import."""
    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    except ImportError as e:
        raise CipherError(f"cryptography package not available: {e}") \
            from e
    return AESGCM


def encrypt(data: bytes) -> tuple[bytes, bytes]:
    """Returns (nonce||ciphertext||tag, key)."""
    key = os.urandom(KEY_SIZE)
    nonce = os.urandom(NONCE_SIZE)
    sealed = _aesgcm()(key).encrypt(nonce, data, None)
    return nonce + sealed, key


def decrypt(data: bytes, key: bytes) -> bytes:
    if len(data) < NONCE_SIZE:
        raise CipherError("ciphertext shorter than nonce")
    try:
        return _aesgcm()(key).decrypt(data[:NONCE_SIZE],
                                      data[NONCE_SIZE:], None)
    except CipherError:
        raise
    except Exception as e:
        raise CipherError(f"decrypt: {e}") from e
