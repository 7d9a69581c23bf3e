"""Graph layer tests: CSR construction, .mtx I/O round-trip, generators.

Mirrors the reference's implicit invariants (symmetrize + dedup + 1-indexed
I/O, serial/lib/adjMatrix.cc:18-52, write path adjMatrix.cc:53-69)."""

import numpy as np
import pytest

from krylov_centrality.graphs.csr import CSRGraph
from krylov_centrality.graphs import io as gio
from krylov_centrality.graphs import generators


def test_from_edges_symmetrize_dedup():
    # duplicate edges, both orientations, and a self-loop
    edges = np.array([[0, 1], [1, 0], [0, 1], [2, 3], [1, 1]])
    g = CSRGraph.from_edges(4, edges)
    g.validate()
    assert g.n == 4
    assert g.edge_count == 2  # (0,1) and (2,3); self-loop dropped
    assert g.nnz == 4
    np.testing.assert_array_equal(g.degrees, [1, 1, 1, 1])
    np.testing.assert_array_equal(g.indices, [1, 0, 3, 2])


def test_mtx_roundtrip(tmp_path):
    g = generators.uniform_random(50, 120, seed=3)
    p = str(tmp_path / "g.mtx")
    gio.write_mtx(g, p)
    g2 = gio.read_mtx(p, use_native=False)
    np.testing.assert_array_equal(g.indptr, g2.indptr)
    np.testing.assert_array_equal(g.indices, g2.indices)


def test_mtx_reader_one_indexed_and_comments(tmp_path):
    p = tmp_path / "t.mtx"
    p.write_text("%%MatrixMarket matrix coordinate pattern symmetric\n"
                 "% comment\n"
                 "3 3 2\n"
                 "1 2\n"
                 "3 2\n")
    g = gio.read_mtx(str(p), use_native=False)
    assert g.n == 3
    assert g.edge_count == 2
    np.testing.assert_array_equal(g.degrees, [1, 2, 1])


def test_uniform_random_properties():
    g = generators.uniform_random(100, 300, seed=0)
    g.validate()
    assert g.edge_count == 300
    # determinism
    g2 = generators.uniform_random(100, 300, seed=0)
    np.testing.assert_array_equal(g.indices, g2.indices)
    g3 = generators.uniform_random(100, 300, seed=1)
    assert not np.array_equal(g.indices, g3.indices)


def test_barabasi_albert_properties():
    n, m = 500, 4
    g = generators.barabasi_albert(n, m, seed=7, use_native=False)
    g.validate()
    # edge count: complete seed on m+1 nodes + m per added node
    expected = m * (m + 1) // 2 + (n - m - 1) * m
    assert g.edge_count == expected
    assert g.degrees.min() >= m
    # heavy tail: max degree far above m
    assert g.max_degree > 4 * m
    # determinism
    g2 = generators.barabasi_albert(n, m, seed=7, use_native=False)
    np.testing.assert_array_equal(g.indices, g2.indices)


def test_stencil_2d():
    g = generators.stencil_2d(5)
    g.validate()
    assert g.n == 25
    assert g.edge_count == 2 * 5 * 4  # grid edges
    assert g.max_degree == 4


def test_clique_union_properties():
    """coPapersDBLP-class generator: community-local cliques, no hubs."""
    g = generators.clique_union(6400, 14_000, seed=0, comm=64, size=8)
    g.validate()
    # mean degree lands near the coPapersDBLP ~56 class target
    assert 40 < g.nnz / g.n < 75
    # clique union inside small communities: bounded max degree (no
    # power-law tail), so the pack needs no row splitting
    assert g.max_degree < 2 * 64
    # community locality: the vast majority of edges stay within a
    # two-community window of the diagonal (what makes this class pack
    # near-diagonal, like the real co-authorship graph)
    rows = g.row_ids()
    local = np.abs(rows - g.indices) < 2 * 64
    assert local.mean() > 0.95
    # determinism
    g2 = generators.clique_union(6400, 14_000, seed=0, comm=64, size=8)
    np.testing.assert_array_equal(g.indices, g2.indices)
