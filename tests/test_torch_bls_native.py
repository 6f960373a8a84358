"""The port's native BLS12-381 loader (``hostcrypto/bls_native.py``) under
concurrent first use: processes and threads that build the library at once
all end with it (or all without it where there is no ``g++``), and no
temporary file is left behind."""

import shutil
import subprocess
import sys
import threading
from pathlib import Path

from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host
from dvt_circuits_tpu_torch.hostcrypto import bls_native

ROOT = Path(__file__).resolve().parent.parent

#: one process's first use: load into a given build directory, then 12345·G
_CHILD = """
import sys
from pathlib import Path
from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host, bls_native
bls_native._BUILD_DIR = Path(sys.argv[1])
lib = bls_native.load()
print("lib" if lib is not None else "none", bls_native.g1_mul(host.G1_GEN, 12345))
"""


def _ladder(pt, k):
    """k·pt by the pure-Python double-and-add (never the native backend)."""
    out = None
    while k:
        if k & 1:
            out = host.g1_add(out, pt)
        pt = host.g1_add(pt, pt)
        k >>= 1
    return out


def test_concurrent_first_loads_build_one_library(tmp_path, monkeypatch):
    """Two processes and two threads of this one load into one empty build
    directory at once (one g++ run each)."""
    monkeypatch.delenv("DVT_DISABLE_NATIVE", raising=False)
    monkeypatch.setattr(bls_native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(bls_native, "_lib", None)
    monkeypatch.setattr(bls_native, "_tried", False)
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    got = []
    threads = [threading.Thread(target=lambda: got.append(bls_native.load())) for _ in range(2)]
    for t in threads:
        t.start()
    outs = [p.communicate(timeout=600) for p in procs]
    for t in threads:
        t.join(timeout=600)
    assert [p.returncode for p in procs] == [0, 0], outs
    assert not any(t.is_alive() for t in threads) and len(got) == 2 and got[0] is got[1]
    if shutil.which("g++"):
        want = f"lib {(_ladder(host.G1_GEN, 12345),)!r}"
        assert [o.strip() for o, _ in outs] == [want, want]
        assert got[0] is not None
        assert bls_native.g1_mul(host.G1_GEN, 12345) == (_ladder(host.G1_GEN, 12345),)
        assert [f.name for f in tmp_path.iterdir()] == [bls_native._library_path().name]
    else:
        assert [o.strip() for o, _ in outs] == ["none None", "none None"]
        assert got == [None, None] and list(tmp_path.iterdir()) == []
