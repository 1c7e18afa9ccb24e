"""The port stands alone: no module of bulletproofs_plus_tpu_torch imports
JAX or the JAX package.  Checked by parsing the sources, not by importing
them (an interpreter here may load JAX at start-up).  Also: state carried
across with convert.py matches the port's own generators exactly."""

import ast
import os

import numpy as np
import pytest
import torch

import bulletproofs_plus_tpu as jbp
import bulletproofs_plus_tpu_torch as tbp
from bulletproofs_plus_tpu_torch.convert import points_from_jax_numpy, scalars_from_jax_numpy

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bulletproofs_plus_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "bulletproofs_plus_tpu"}


def _sources():
    for root, _dirs, files in os.walk(PORT):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)


def test_port_sources_import_no_jax():
    files = list(_sources())
    assert len(files) > 20
    offenders = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, PORT)}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert not offenders, offenders
    with open(os.path.join(os.path.dirname(PORT), "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not roots & FORBIDDEN


def _limbs(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("bits, parties, degree", [(8, 2, 1), (4, 1, 3)])
def test_convert_generators_match_port(bits, parties, degree):
    jpc = jbp.create_pedersen_gens_with_extension_degree(jbp.ExtensionDegree(degree))
    tpc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(degree))
    jgens = jbp.BulletproofGens(bits, parties)
    tgens = tbp.BulletproofGens(bits, parties)

    carried = points_from_jax_numpy(*(np.asarray(c) for c in jgens.interleaved_device()), device="cpu")
    own = tgens.interleaved_device("cpu")
    assert carried.x.dtype == torch.int64 and carried.x.shape == (2 * bits * parties, 16)
    for c, o in zip(carried, own):
        assert np.array_equal(_limbs(c), _limbs(o))

    for jp, tp in zip(jpc.device_bases(), tpc.device_bases("cpu")):
        carried = points_from_jax_numpy(*(np.asarray(c) for c in jp), device="cpu")
        for c, o in zip(carried, tp):
            assert np.array_equal(_limbs(c), _limbs(o))


def test_convert_scalars_checks_layout():
    from bulletproofs_plus_tpu.ops.limbs import pack_ints

    arr = pack_ints([0, 1, 2**255 + 12345])
    t = scalars_from_jax_numpy(arr, device="cpu")
    assert t.dtype == torch.int64 and np.array_equal(t.numpy(), arr.astype(np.int64))
    with pytest.raises(ValueError):
        scalars_from_jax_numpy(np.zeros((3, 8), np.uint32), device="cpu")
    with pytest.raises(ValueError):
        scalars_from_jax_numpy(np.full((1, 16), 1 << 16, np.uint32), device="cpu")
