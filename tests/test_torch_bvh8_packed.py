"""K5's packed layout (`render/bvh8.py::pack_bvh8`) against the 8-wide row
table it is built from, on the CPU.

The layout is decoded with nothing but its own arrays: a record's child
count comes from the meta word that points at it (the root's from
`packed_root`), and the records are in the order of their blocks' first
table rows, so record r's block starts at the sum of the counts before it.
Rebuilt so, the table must come back bit for bit, and equal the JAX
package's `render/bvh8.py` table (its first 16 lanes) for the same soup.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.render import bvh8 as jbvh8
from bsdf_diffusion_sampling_tpu_torch.render import traverse8 as t8
from bsdf_diffusion_sampling_tpu_torch.render.bvh8 import META_BASE_BITS, META_FLAGS_SHIFT, build_bvh8, pack_bvh8

from _torch_port import random_meshes, soups, sphere_on_plane

MASK = (1 << META_BASE_BITS) - 1


def _split(meta: int):
    flags = meta >> META_FLAGS_SHIFT
    return meta & MASK, flags, ((flags >> 3) & 7) + 1, bool(flags & 1)


@pytest.fixture(scope="module", params=["sphere_on_plane", "random"])
def scene(request):
    meshes, mids = sphere_on_plane() if request.param == "sphere_on_plane" else random_meshes(
        np.random.default_rng(3))
    js, ts = soups(meshes, mids)
    return build_bvh8(ts), jbvh8.build_bvh8(js)


def _counts(b8) -> np.ndarray:
    """Each record's child count, read from the one meta word that points at
    it; -1 where no word does, and an error where two do."""
    nodes = b8.nodes.numpy()
    counts = np.full(nodes.shape[0], -1, np.int64)
    refs = [b8.packed_root]
    for r in range(nodes.shape[0]):
        refs += [int(m) for m in nodes[r, 48:56] if m != 0 and not _split(int(m))[3]]
    for meta in refs:
        base, _, cnt, _ = _split(meta)
        assert counts[base] == -1, f"record {base} is pointed at twice"
        counts[base] = cnt
    return counts


def _decode(b8) -> tuple[np.ndarray, int]:
    """The row table and the root meta word rebuilt from the packed arrays."""
    nodes, tris = b8.nodes.numpy(), b8.tris.numpy()
    counts = _counts(b8)
    assert (counts > 0).all()
    block = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tri0 = int(counts.sum())
    n_rows = ((tri0 + len(tris) + 7) // 8) * 8 + 8
    table = np.zeros((n_rows, 16), np.float32)
    bits = table.view(np.int32)
    for r, cnt in enumerate(counts):
        for k in range(cnt):
            row = block[r] + k
            bits[row, 0:6] = nodes[r, [8 * lane + k for lane in range(6)]]
            base, flags, _, leaf = _split(int(nodes[r, 48 + k]))
            table[row, 12] = float(base + tri0 if leaf else block[base])
            table[row, 13] = float(flags)
    table[tri0:tri0 + len(tris), :12] = tris
    root_base, root_flags, _, _ = _split(b8.packed_root)
    return table, (root_flags << META_FLAGS_SHIFT) | int(block[root_base])


def test_decoding_gives_back_the_table_bit_for_bit(scene):
    b8, jb8 = scene
    table, root_meta = _decode(b8)
    assert table.shape == tuple(b8.table.shape)
    np.testing.assert_array_equal(table.view(np.uint32), b8.table.numpy().view(np.uint32))
    np.testing.assert_array_equal(table.view(np.uint32), np.asarray(jb8.table)[:, :16].view(np.uint32))
    assert root_meta == b8.root_meta == jb8.root_meta


def test_every_meta_word_points_inside_the_packed_arrays(scene):
    b8, _ = scene
    nodes, n_tris = b8.nodes.numpy(), b8.tris.shape[0]
    counts = _counts(b8)
    assert (counts > 0).all(), "a record no meta word points at"
    for r, cnt in enumerate(counts):
        assert not nodes[r, 56:].any()
        for k in range(cnt):
            base, _, c, leaf = _split(int(nodes[r, 48 + k]))
            if leaf:
                assert base + c <= n_tris
            else:
                assert base < nodes.shape[0]
        for lane in range(7):
            assert not nodes[r, 8 * lane + cnt:8 * lane + 8].any()
    # every triangle is in exactly one leaf
    covered = np.zeros(n_tris, np.int64)
    for r, cnt in enumerate(counts):
        for k in range(cnt):
            base, _, c, leaf = _split(int(nodes[r, 48 + k]))
            if leaf:
                covered[base:base + c] += 1
    assert (covered == 1).all()


def test_the_jax_table_packs_to_the_same_arrays(scene):
    b8, jb8 = scene
    nodes, tris, root = pack_bvh8(np.asarray(jb8.table)[:, :16], jb8.root_meta, jb8.tri0, b8.tris.shape[0])
    np.testing.assert_array_equal(nodes, b8.nodes.numpy())
    np.testing.assert_array_equal(tris.view(np.uint32), b8.tris.numpy().view(np.uint32))
    assert root == b8.packed_root
    assert b8.packed_bytes == 4 * (nodes.size + tris.size)


def test_to_moves_the_packed_arrays(scene):
    b8, _ = scene
    moved = b8.to("meta")
    assert moved.nodes.device.type == "meta" and moved.tris.device.type == "meta"
    assert moved.nodes.dtype == torch.int32 and moved.tris.dtype == torch.float32


@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_wrapper_rejects_other_devices(scene, any_hit):
    b8, _ = scene
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        t8.traverse8(b8.to("meta"), x, x, x, torch.zeros(4, device="meta"),
                     torch.ones(4, dtype=torch.bool, device="meta"), any_hit)
