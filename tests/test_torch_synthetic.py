"""The port's synthetic fixtures against the JAX package's, on the CPU.

Both `generate_fixtures` write into the same path (the JAX tree is moved
aside first, since the MSA CSVs hold absolute paths) from the same seed:
every text file must be equal byte for byte and every HDF5 dataset equal
array for array. Without h5py, `ensure_fixtures` raises ImportError naming
it, and reads existing fixtures without importing it.
"""

import os
import sys

import h5py
import numpy as np
import pytest

from oneprot_tpu.data.synthetic import generate_fixtures as jax_generate
from oneprot_tpu_torch.data import synthetic


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as h5:
        h5.visititems(lambda name, obj: out.__setitem__(name, (
            obj.dtype.str, obj.shape, obj[()]))
            if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("seed,n_train,n_eval", [(0, 8, 4), (3, 5, 2)])
def test_fixtures_match_jax(tmp_path, seed, n_train, n_eval):
    d = str(tmp_path / "fx")
    ids_jax = jax_generate(d, n_train=n_train, n_eval=n_eval, seed=seed)
    os.rename(d, str(tmp_path / "fx_jax"))
    ids = synthetic.generate_fixtures(d, n_train=n_train, n_eval=n_eval,
                                      seed=seed)
    assert ids == ids_jax
    files = _files(d)
    assert files == _files(str(tmp_path / "fx_jax"))
    assert {f for f in files if f.endswith(".h5")} == {
        "seqstruc.h5", "pockets_100_residues.h5", "train_saprot.h5"}
    for rel in files:
        mine, theirs = os.path.join(d, rel), str(tmp_path / "fx_jax" / rel)
        if rel.endswith(".h5"):
            a, b = _datasets(mine), _datasets(theirs)
            assert sorted(a) == sorted(b) and a
            for name in a:
                assert a[name][:2] == b[name][:2], (rel, name)
                np.testing.assert_array_equal(a[name][2], b[name][2])
        else:
            with open(mine, "rb") as f, open(theirs, "rb") as g:
                assert f.read() == g.read(), rel
    # a second call reads the marker and writes nothing
    assert synthetic.ensure_fixtures(d, seed=seed + 1) == d
    assert _files(d) == files


def test_ensure_fixtures_without_h5py(tmp_path, monkeypatch):
    d = str(tmp_path / "fx")
    synthetic.generate_fixtures(d, n_train=2, n_eval=1)
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert synthetic.ensure_fixtures(d) == d  # existing fixtures: no import
    with pytest.raises(ImportError, match="h5py"):
        synthetic.ensure_fixtures(str(tmp_path / "empty"))
