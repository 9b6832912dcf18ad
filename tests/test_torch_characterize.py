"""The port's automated pre-characterization (§4 -> the §5.2 database)
against the reference's: ``characterize`` and ``characterize_sweep`` give
equal ``CharRecord``s for the same jobs, clusters and network models, and
the characterization DB built from them answers the same lookups."""

import dataclasses

import pytest

import repro.core as R
import repro.topo as RT
import repro_torch.core as P
import repro_torch.topo as PT

PKGS = (R, P)
TOPO = {R: RT, P: PT}


def dense_model(pkg, layers=32, h=4096):
    return pkg.ModelSpec(name=f"dense-{layers}L", hidden=h, layers=layers, vocab=50304,
                         seq_len=2048, global_batch=512, micro_batch=1, d_ff=4 * h)


def moe_model(pkg):
    return pkg.ModelSpec(name="moe", hidden=4096, layers=32, vocab=50304, seq_len=2048,
                         global_batch=512, micro_batch=1, n_experts=16, top_k=4, d_expert=8192)


def record(rec):
    assert type(rec).__name__ == "CharRecord"
    return dataclasses.asdict(rec), rec.affinity()


JOBS = {
    "deep-pp": lambda pkg: pkg.JobSpec(n_gpus=64 * 8, tp=8, pp=8, model=dense_model(pkg)),
    "shallow": lambda pkg: pkg.JobSpec(n_gpus=32 * 8, tp=8, pp=4, model=dense_model(pkg, 16)),
    "moe": lambda pkg: pkg.JobSpec(n_gpus=64 * 8, tp=8, pp=8, model=moe_model(pkg)),
    "l20": lambda pkg: pkg.JobSpec(n_gpus=16 * 8, tp=4, pp=2, model=dense_model(pkg, 24, 2048),
                                   gpu_type="L20"),
}


class TestCharacterize:
    @pytest.mark.parametrize("job", sorted(JOBS))
    def test_same_record(self, job):
        out = [record(pkg.characterize(JOBS[job](pkg), lambda pkg=pkg: pkg.Cluster.uniform(8, 12)))
               for pkg in PKGS]
        assert out[1] == out[0]
        rec, (a, b) = out[1]
        assert rec["j_dp"] >= 0 and rec["j_pp"] >= 0 and abs(a + b - 1.0) < 1e-9

    def test_pp_wins_for_deep_pipelines(self):
        rec = P.characterize(JOBS["deep-pp"](P), lambda: P.Cluster.uniform(8, 12))
        assert rec.j_pp >= rec.j_dp and rec.unit == "pp" and rec.affinity()[0] <= 0.5
        assert rec.j_pp > 0

    @pytest.mark.parametrize("kind", ["rail-only", "torus", "dragonfly"])
    def test_fabric_net_model_and_step_options(self, kind):
        def one(pkg):
            factory = lambda: pkg.Cluster.from_fabric(TOPO[pkg].comparable_fabric(kind, [12] * 8))
            net = pkg.fabric_net_model(factory().fabric)
            return record(pkg.characterize(JOBS["shallow"](pkg), factory, net=net, steps=3,
                                           mfu=0.3, overlap=0.5))

        assert one(P) == one(R)

    def test_sweep_feeds_db_and_lookup_uses_it(self):
        out = []
        for pkg in PKGS:
            jobs = [JOBS["shallow"](pkg), JOBS["moe"](pkg)]
            recs = pkg.characterize_sweep(jobs, lambda pkg=pkg: pkg.Cluster.uniform(8, 12))
            db = pkg.CharacterizationDB(records=recs)
            comm = pkg.build_comm_matrix(jobs[0])
            r1, r2 = comm.ratios()
            nearest = db.lookup(r1, r2)
            moe = db.affinity_for(pkg.build_comm_matrix(jobs[1]))
            out.append(([record(r) for r in recs], db.affinity_for(comm), moe,
                        dataclasses.asdict(nearest)))
        assert out[1] == out[0]
        _, (alpha, beta, _), _, nearest = out[1]
        assert abs(alpha + beta - 1.0) < 1e-9 and nearest["model_name"] == "dense-16L"
