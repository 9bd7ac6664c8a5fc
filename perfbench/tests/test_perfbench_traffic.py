"""The traffic files and the one generator that reads them."""

from perfbench import traffic


def test_l137_step_is_eighteen_packets_of_eight_levels():
    t = traffic.load("l137-step")
    ps = t.packets()
    assert len(ps) == 18
    assert [(p.nuv, p.nsc) for p in ps] == \
        [(8, 17)] + [(8, 16)] * 16 + [(1, 2)]
    assert [t.outputs(p) for p in (ps[0], ps[1], ps[-1])] == [83, 80, 10]
    # every level's T and q once, the surface pressure in the first packet
    rows = sorted(r for p in ps for r in p.sc_rows)
    assert rows == list(range(275)) and ps[0].sc_rows[-1] == 274
    assert sum(p.nuv for p in ps) == 137 == t.nuv and t.nsc == 275
    assert t.calls()[:2] == [("inv", 8, 17), ("dir", 8, 17)]
    assert len(t.calls()) == 36


def test_l137_step_families_cover_every_output_field():
    t = traffic.load("l137-step")
    p = t.packets()[0]
    fam = t.families(p)
    assert [f[0] for f in fam] == ["inv.uv", "inv.sc", "inv.sc_ns",
                                   "inv.uv_ew", "inv.sc_ew"]
    assert fam[0][1] == 0 and fam[-1][2] == t.outputs(p)
    assert all(a[2] == b[1] for a, b in zip(fam, fam[1:]))


def test_f1_round_trip_is_one_field():
    t = traffic.load("f1-rt")
    (p,) = t.packets()
    assert (p.nuv, p.nsc, p.sc_rows) == (0, 1, (0,))
    assert t.outputs(p) == 1
    assert t.families(p) == [("inv.sc", 0, 1)]
    assert t.calls() == [("inv", 0, 1), ("dir", 0, 1)]
