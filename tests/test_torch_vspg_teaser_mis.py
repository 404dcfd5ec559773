"""B3c/B4c in the MIS direction mode: as tests/test_torch_vspg_teaser.py
(the plain versions against the interpret-mode Pallas kernel on the
teaser machines), one-sample MIS of the phase function or the BSDF and the
guiding mixture."""

from test_torch_vspg_teaser import record_then_render


def test_teaser_plain_matches_pallas_mis():
    """0.98 of lanes and pixels (measured 0.9961 and 0.9961 on this CPU)."""
    f_rec, f_ren, m, m_ref = record_then_render("mis")
    assert f_rec >= 0.98 and f_ren >= 0.98, (f_rec, f_ren)
    assert abs(m - m_ref) < 0.02 * m_ref
