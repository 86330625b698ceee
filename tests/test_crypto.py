"""KATs and cross-implementation checks for the crypto layer (reference L0:
src/crypto/{prg,hash,ro}.rs)."""

import numpy as np
import pytest

from reverie_tpu.crypto import (
    RandomOracle,
    blake3,
    blake3_many,
    blake3_xof,
    expand_seed,
    keystream,
    keystream_batch,
)
from reverie_tpu.crypto.blake3_py import blake3_py

# Official BLAKE3 test vector (empty input).
BLAKE3_EMPTY = "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262"


def test_blake3_empty_vector():
    assert blake3(b"").hex() == BLAKE3_EMPTY


@pytest.mark.parametrize(
    "n", [0, 1, 2, 3, 4, 63, 64, 65, 127, 128, 129, 1023, 1024, 1025, 2048, 2049, 3072, 4096, 5000, 10000, 31744, 102400]
)
def test_blake3_cross_impl(n):
    data = bytes(i % 251 for i in range(n))
    assert blake3(data) == blake3_py(data)
    assert blake3_xof(data, 200) == blake3_py(data, 200)


def test_blake3_many():
    data = np.frombuffer(bytes((i * 7 + 3) % 251 for i in range(4 * 1000)), dtype=np.uint8)
    rows = data.reshape(4, 1000)
    out = blake3_many(rows)
    for i in range(4):
        assert out[i].tobytes() == blake3(rows[i].tobytes())


def test_aes_ctr_vs_cryptography():
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    for key in [b"\x00" * 16, bytes(range(16)), b"\xab" * 16]:
        enc = Cipher(algorithms.AES(key), modes.CTR(b"\x00" * 16)).encryptor()
        want = enc.update(b"\x00" * 1024)
        assert keystream(key, 1024) == want


def test_aes_ctr_start_block():
    key = bytes(range(16))
    full = keystream(key, 160)
    tail = keystream(key, 80, start_block=5)
    assert tail == full[80:]


def test_keystream_batch_matches_single():
    keys = np.arange(3 * 16, dtype=np.uint8).reshape(3, 16)
    out = keystream_batch(keys, 64)
    for i in range(3):
        assert out[i].tobytes() == keystream(keys[i].tobytes(), 64)


def test_expand_seed_shape_and_determinism():
    seed = bytes(range(16))
    keys = expand_seed(seed)
    assert keys.shape == (8, 16)
    # flat keystream split: player i key = keystream bytes [16i, 16i+16)
    ks = keystream(seed, 128)
    assert keys.tobytes() == ks


def test_random_oracle_stream_consistency():
    ro1 = RandomOracle("random-oracle challenge", b"abc")
    ro2 = RandomOracle("random-oracle challenge", b"abc")
    a = ro1.fill(16) + ro1.fill(16) + ro1.fill(5)
    b = ro2.fill(37)
    assert a == b
    # matches raw XOF of ctx || 0x00 || input
    assert b == blake3_xof(b"random-oracle challenge\x00abc", 37)


_BUILD_RACE = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
native._NATIVE_DIR = sys.argv[2]
native._LIB_PATH = sys.argv[2] + "/libreverie_native.so"
out = bytearray(16)
native.get_lib().aes128_encrypt_block(bytes(16), bytes(16), (__import__("ctypes").c_char * 16).from_buffer(out))
print(out.hex())
"""


def test_native_build_from_many_processes(tmp_path):
    """Processes that find no library all load a whole one: the build is
    locked and renamed into place, never loaded while half written."""
    import os
    import shutil
    import subprocess
    import sys

    from reverie_tpu.crypto import native

    for f in os.listdir(native._NATIVE_DIR):
        if f == "Makefile" or f.endswith(".c"):
            shutil.copy(os.path.join(native._NATIVE_DIR, f), tmp_path)
    procs = [
        subprocess.Popen([sys.executable, "-c", _BUILD_RACE, native.__file__, str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(8)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 8, [err for _, err in outs]
    # AES-128 of the zero block under the zero key.
    assert {out.strip() for out, _ in outs} == {"66e94bd4ef8a2c3b884cfa59ca342b2e"}
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["Makefile", "aes_ctr.c", "blake3_ref.c", "libreverie_native.so"])
