"""The port's fabrics and cluster model against the reference's: the same
constructor arguments through ``repro.topo``/``repro.core.topology`` and
``repro_torch.topo``/``repro_torch.core.topology`` give equal domain
structure, hop distances, bisections, scheduling blocks and free masks.
Every comparison is exact (``==`` / ``np.array_equal``)."""

import numpy as np
import pytest

import repro.core as R
import repro.topo as RT
import repro_torch.core as P
import repro_torch.topo as PT

# (family, constructor arguments, constructor keyword arguments): two sizes
# of each fabric, non-uniform where the family allows it
FABRICS = [
    ("clos", ([6, 5, 7],), {}),
    ("clos", ([12, 9, 16, 3, 8, 11, 10],), {"nodes_per_rack": 4}),
    ("rail-only", ([4, 4, 4, 4],), {"rails": 4}),
    ("rail-only", ([8, 6, 8, 7, 5, 8],), {}),
    ("torus", ((2, 3),), {"nodes_per_domain": 4}),
    ("torus", ((2, 2, 3),), {"nodes_per_domain": [2, 3, 1, 4, 2, 2, 3, 1, 2, 2, 5, 1]}),
    ("torus", ((4, 4),), {"nodes_per_domain": 2}),
    ("dragonfly", (3,), {"routers_per_group": 2, "nodes_per_router": 4}),
    ("dragonfly", (4,), {"routers_per_group": 3,
                         "nodes_per_router": [3, 2, 4, 1, 5, 2, 3, 3, 2, 4, 1, 2]}),
]
CAPS = [[5, 7, 6, 6, 8, 4], [9, 3, 7, 4, 6, 8, 2, 5, 7]]


def fabric_pair(kind, args, kwargs):
    return RT.get_fabric(kind, *args, **kwargs), PT.get_fabric(kind, *args, **kwargs)


def assert_same_fabric(ref, port):
    assert type(port).__name__ == type(ref).__name__ and port.kind == ref.kind
    assert isinstance(port, PT.Fabric)
    assert (port.n_nodes, port.n_domains) == (ref.n_nodes, ref.n_domains)
    assert np.array_equal(port.domain_index(), ref.domain_index())
    assert port.domain_index().dtype == ref.domain_index().dtype
    k = ref.n_domains
    for d in range(k):
        assert port.domain_nodes(d) == ref.domain_nodes(d)
    for n in range(ref.n_nodes):
        assert port.coords(n) == ref.coords(n)
    assert [[port.domain_distance(a, b) for b in range(k)] for a in range(k)] == \
        [[ref.domain_distance(a, b) for b in range(k)] for a in range(k)]
    assert port.diameter() == ref.diameter()
    for q in range(0, k + 2):
        assert port.distance_at_spread(q) == ref.distance_at_spread(q), q
    rng = np.random.default_rng(k)
    subsets = [list(range(k)), list(range(k))[::-1], [0], []]
    subsets += [sorted(rng.choice(k, size=int(rng.integers(1, k + 1)), replace=False).tolist())
                for _ in range(6)]
    for ds in subsets:
        assert port.partition(ds) == ref.partition(ds), ds
    for size in range(1, k + 2):
        assert port.scheduling_blocks(size) == ref.scheduling_blocks(size)


class TestFabrics:
    @pytest.mark.parametrize("kind,args,kwargs", FABRICS,
                             ids=[f"{f[0]}-{i}" for i, f in enumerate(FABRICS)])
    def test_same_structure_distances_and_blocks(self, kind, args, kwargs):
        assert_same_fabric(*fabric_pair(kind, args, kwargs))

    @pytest.mark.parametrize("kind", ["clos", "fat-tree", "rail-only", "rail", "torus",
                                      "dragonfly"])
    @pytest.mark.parametrize("caps", CAPS, ids=["6-domains", "9-domains"])
    def test_comparable_fabric(self, kind, caps):
        assert_same_fabric(RT.comparable_fabric(kind, caps), PT.comparable_fabric(kind, caps))

    def test_most_square(self):
        for n in range(1, 200):
            assert PT._most_square(n) == RT._most_square(n)

    def test_registry_names_and_aliases(self):
        assert PT.list_fabrics() == RT.list_fabrics()
        for alias in ("rail", "railonly", "fat_tree", "minipod", "Torus", "DRAGONFLY"):
            assert PT.fabric_class(alias).__name__ == RT.fabric_class(alias).__name__
        with pytest.raises(KeyError):
            PT.fabric_class("hypercube")
        with pytest.raises(ValueError):
            PT.register_fabric("clos", PT.ClosFabric)

    def test_registries_are_separate(self):
        name = "torch-topo-test-fabric"

        @PT.register_fabric(name)
        class Ring(PT.BaseFabric):
            kind = name

            def domain_distance(self, a, b):
                return min(abs(a - b), self.n_domains - abs(a - b))

        from repro_torch.topo import fabric as port_fabric
        try:
            assert name in PT.list_fabrics() and name not in RT.list_fabrics()
            fab = PT.get_fabric(name, [2, 3, 2, 1, 4])
            assert fab.diameter() == 2 and fab.distance_at_spread(3) == 2
        finally:
            del port_fabric._REGISTRY[name]
        assert PT.list_fabrics() == RT.list_fabrics()

    @pytest.mark.parametrize("kind,args,kwargs", [
        ("clos", ([4, 0],), {}), ("clos", ([4],), {"nodes_per_rack": 0}),
        ("rail-only", ([4],), {"rails": 0}), ("torus", ((2,),), {}),
        ("torus", ((2, 2),), {"nodes_per_domain": [1, 2]}),
        ("dragonfly", (0,), {}), ("dragonfly", (2,), {"routers_per_group": 2,
                                                     "nodes_per_router": [1, 2, 3]}),
    ])
    def test_same_constructor_errors(self, kind, args, kwargs):
        with pytest.raises(ValueError) as ref:
            RT.get_fabric(kind, *args, **kwargs)
        with pytest.raises(ValueError) as port:
            PT.get_fabric(kind, *args, **kwargs)
        assert str(port.value) == str(ref.value)


def node_tuples(cluster):
    return [(n.node_id, n.minipod, n.rack, n.gpus) for n in cluster.nodes.values()]


def assert_same_cluster(ref, port):
    assert node_tuples(port) == node_tuples(ref)
    assert [(p.pod_id, p.node_ids) for p in port.minipods] == \
        [(p.pod_id, p.node_ids) for p in ref.minipods]
    assert np.array_equal(port.domain_index, ref.domain_index)
    assert np.array_equal(port.free_mask_view(), ref.free_mask_view())
    assert np.array_equal(port.free_node_ids(), ref.free_node_ids())
    assert port.n_free == ref.n_free and port.snapshot_free() == ref.snapshot_free()
    assert port.free_capacities() == ref.free_capacities()
    for q in (1, 2, 3, 8):
        assert port.free_signature(q) == ref.free_signature(q)
    for d in range(ref.n_domains):
        assert port.free_in_domain(d) == ref.free_in_domain(d)
        assert port.free_in_minipod(d) == ref.free_in_minipod(d)
    assert port.scheduling_blocks(2) == ref.scheduling_blocks(2)
    assert port.partition_domains(range(ref.n_domains)) == \
        ref.partition_domains(range(ref.n_domains))


def cluster_pairs():
    yield "paper-i", R.Cluster.paper_setting("i"), P.Cluster.paper_setting("i")
    yield "paper-ii", R.Cluster.paper_setting("ii"), P.Cluster.paper_setting("ii")
    yield "paper-iii", R.Cluster.paper_setting("iii"), P.Cluster.paper_setting("iii")
    yield "uniform", R.Cluster.uniform(5, 7, nodes_per_rack=3), \
        P.Cluster.uniform(5, 7, nodes_per_rack=3)
    for i, (kind, args, kwargs) in enumerate(FABRICS):
        ref, port = fabric_pair(kind, args, kwargs)
        yield f"{kind}-{i}", R.Cluster.from_fabric(ref), P.Cluster.from_fabric(port)


class TestCluster:
    @pytest.mark.parametrize("name,ref,port", list(cluster_pairs()),
                             ids=[c[0] for c in cluster_pairs()])
    def test_masks_after_the_same_allocate_release_sequence(self, name, ref, port):
        assert_same_cluster(ref, port)
        rng = np.random.default_rng(len(name))
        n = ref.n_nodes
        for step in range(40):
            k = int(rng.integers(0, max(2, n // 4)))
            ids = rng.choice(n, size=k, replace=False).tolist()
            if step % 3 == 2:
                ids = ids + ids[:2]           # duplicates collapse
            if step % 2 == 0:
                ids = [i for i in ids if ref.is_free(i)]
                ref.allocate(ids)
                port.allocate(ids)
            else:
                ref.release(ids)              # releasing a free node is a no-op
                port.release(ids)
            assert_same_cluster(ref, port)
        for node in (-1, 0, n - 1, n):
            assert port.is_free(node) == ref.is_free(node)

    def test_same_errors(self):
        ref, port = R.Cluster([3, 4]), P.Cluster([3, 4])
        for c in (ref, port):
            c.allocate([1, 2])
        msgs = []
        for c in (ref, port):
            errs = []
            for op, ids in ((c.allocate, [2, 3]), (c.allocate, [9]), (c.release, [-1]),
                            (c.release, [7]), (c.free_signature, 0)):
                with pytest.raises(ValueError) as e:
                    op(ids)
                errs.append(str(e.value))
            with pytest.raises(ValueError) as e:
                type(c)()
            errs.append(str(e.value))
            msgs.append(errs)
        assert msgs[0] == msgs[1]
        assert_same_cluster(ref, port)

    def test_gpus_per_node(self):
        from repro.core import topology as ref_topology
        from repro_torch.core import topology as port_topology

        assert port_topology.GPUS_PER_NODE == ref_topology.GPUS_PER_NODE == 8
