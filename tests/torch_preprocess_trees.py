"""Compare two processed scene trees file by file (no tests of its own).

The port's converters must write what the JAX package's write: every
file of one tree is in the other, and
- `.txt` (poses and intrinsics by np.savetxt, the ego-mask README) and
  `.bin` (lidar) byte for byte;
- `.json` equal as parsed;
- `.jpg` and `.png` decoded by PIL, pixel for pixel;
- `.pkl` (smpl.pkl, tracker outputs) unpickled, arrays equal with their
  dtypes.
`text_subs` maps a string of tree `a` to the string tree `b` writes in
its place in text files (the ego-mask README names each package's CLI).
"""
import json
import os
import pickle

import numpy as np
from PIL import Image


def files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def same(a, b, where: str):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, f"{where}: {a!r} != {b!r}"


def assert_trees_equal(a: str, b: str, text_subs=None) -> int:
    """Every file of `a` equals its counterpart in `b`; returns the count."""
    names = files(a)
    assert names == files(b), set(names) ^ set(files(b))
    for rel in names:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        ext = os.path.splitext(rel)[1]
        if ext in (".jpg", ".png"):
            with Image.open(pa) as ia, Image.open(pb) as ib:
                assert ia.mode == ib.mode, rel
                assert np.array_equal(np.asarray(ia), np.asarray(ib)), rel
        elif ext == ".json":
            with open(pa) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb), rel
        elif ext == ".pkl":
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                same(pickle.load(fa), pickle.load(fb), rel)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                da, db = fa.read(), fb.read()
            if ext == ".txt":
                for old, new in (text_subs or {}).items():
                    da = da.replace(old.encode(), new.encode())
            assert da == db, rel
    return len(names)
