"""LAMMPS molecule files: the port's io.molecule.read_molecule against the
JAX package's reader, and config.MolTemplate.from_file against the JAX
package's, on files the tests write: one by hand (comments, blank lines,
sections out of order, a section neither reader takes, ids out of order)
and the star template of scenes.write_star_molecule (io.molecule's
writer).  Every array exactly equal; the template displacements (float64)
equal to the last bit."""
import numpy as np
import pytest

from obmd_tpu.config import MolTemplate as JMolTemplate
from obmd_tpu.io.molecule import read_molecule as j_read
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.config import MolTemplate
from obmd_tpu_torch.io.molecule import (MoleculeTemplate, read_molecule,
                                        write_molecule)

from test_torch_support import _mirror

HAND = """water-like trimer with a tail   # title

3 atoms
2 bonds   # two O-H
1 angles

Types

2 2
1 1
3 2

Coords   # ids out of order

3 -0.2 0.9 0.0
1 0.0 0.0 0.0
2 0.95 0.0 0.0

Special Bond Counts

1 2 0 0
2 1 1 0
3 1 1 0

Charges

1 -0.8
2 0.4
3 0.4

Bonds

1 1 1 2
2 1 1 3

Angles

1 1 2 1 3
"""

FIELDS = ("natoms", "x", "types", "q", "masses", "bonds", "angles",
          "dihedrals", "impropers", "rep_atom")


def _same(got, want):
    for k in FIELDS:
        g, w = getattr(got, k), getattr(want, k)
        if w is None:
            assert g is None, k
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w)), k
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
    assert np.array_equal(got.center, want.center)
    assert np.array_equal(got.dx, want.dx)


@pytest.mark.parametrize("source", ["hand", "star", "star_arm1"])
def test_read_molecule_matches_jax(tmp_path, source):
    """read_molecule and MolTemplate.from_file against the JAX package's
    on the same file: every section array, the center and the
    displacements, and the template's fields one by one."""
    path = str(tmp_path / "tpl.mol")
    if source == "hand":
        with open(path, "w") as fh:
            fh.write(HAND)
    else:
        pscenes.write_star_molecule(path, 1.0 if source == "star_arm1"
                                    else 0.55)
    got, want = read_molecule(path), j_read(path)
    _same(got, want)
    _mirror(MolTemplate.from_file(path), JMolTemplate.from_file(path))
    if source == "hand":
        assert got.natoms == 3 and got.types.tolist() == [0, 1, 1]
        assert got.bonds.tolist() == [[1, 1, 2], [1, 1, 3]]
        assert got.q.tolist() == [-0.8, 0.4, 0.4]
    else:
        tpl = MolTemplate.from_file(path)
        assert tpl.natoms == 5 and len(tpl.bonds) == 4
        assert len(tpl.angles) == 6 and tpl.impropers == ((1, 1, 0, 2, 3),)
        np.testing.assert_allclose(np.asarray(tpl.dx).mean(0), 0.0,
                                   atol=1e-15)


def test_write_molecule_round_trip(tmp_path):
    """write_molecule then read_molecule gives the template back (types
    0-based, ids 1-based, every section), with masses and dihedrals."""
    r = np.random.default_rng(3)
    tpl = MoleculeTemplate(
        natoms=4, x=r.normal(size=(4, 3)), types=np.asarray([0, 2, 1, 0]),
        q=r.normal(size=4), masses=np.asarray([1.0, 2.0, 3.0, 4.0]),
        bonds=np.asarray([[1, 1, 2], [2, 2, 3], [1, 3, 4]], np.int32),
        angles=np.asarray([[1, 1, 2, 3], [2, 2, 3, 4]], np.int32),
        dihedrals=np.asarray([[1, 1, 2, 3, 4]], np.int32))
    path = str(tmp_path / "rt.mol")
    write_molecule(path, tpl)
    back = read_molecule(path)
    _same(back, j_read(path))
    for k in ("x", "q", "masses"):
        assert np.array_equal(getattr(back, k), getattr(tpl, k)), k
    for k in ("types", "bonds", "angles", "dihedrals"):
        assert np.array_equal(getattr(back, k), getattr(tpl, k)), k
    assert back.impropers is None
