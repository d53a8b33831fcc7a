"""``step_profile.py`` places its ``clock64`` probes in a copy of the dense
kernels' source by text anchors, and in ``td_estep``'s by its marker
comments.  The probed build runs only on a card, so these tests hold the
anchors to the source as it stands: every probe is placed, each barrier of
the position loops gets its block probe, the source itself carries no
probe, and a source that has lost an anchor is refused."""

import os
import re

import pytest

import step_profile as sp

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), sp.SOURCE)


def _source() -> str:
    with open(_SRC) as fh:
        return fh.read()


def test_probes_match_the_current_kernels():
    src = _source()
    assert "TD_" not in src and "clock64" not in src
    text = sp.instrument(src)
    wrp = {int(k) for k in re.findall(r"TD_WRP\((\d+)\)\n", text)}
    assert wrp == set(sp.PROBES["bwd"]["wrp"]) | set(sp.PROBES["fwd"]["wrp"])
    # two barriers a position in each of K1 and K2, one block probe each
    assert len(re.findall(r"TD_BLK\((\d+)\)\n", text)) == 2 * 2
    assert text.count("TD_BEGIN\n") == 2


@pytest.mark.parametrize("fn", ["dense_step", "bwd_dense", "fwd_dense"])
def test_a_source_without_an_anchor_is_refused(fn):
    """Each probed function's first anchor taken out of the source: the
    script stops and names the function rather than profile without it."""
    anchor = dict(sp.PROBES["edits"])[fn][0][0]
    src = _source()
    a, b = sp.function_span(src, fn)
    broken = src[:a] + src[a:b].replace(anchor, "", 1) + src[b:]
    with pytest.raises(SystemExit, match=fn):
        sp.instrument(broken)


def test_estep_probes_match_the_current_kernel():
    """td_estep, through the same ``instrument``: the clock starts once, each
    of its marker comments (after every barrier of its position loop and
    after the final flush) becomes its block probe, in order, no marker is
    left, and a source without any one of its markers is refused."""
    src = open(os.path.join(os.path.dirname(_SRC), "estep.cu")).read()
    assert "clock64" not in src and "TD_BLK" not in src and "TD_BEGIN" not in src
    text = sp.instrument(src, sp.ESTEP_PROBES)
    blk = [int(k) for k in re.findall(r"TD_BLK\((\d+)\)\n", text)]
    names = sp.ESTEP_PROBES["blk"] + sp.ESTEP_PROBES["once"]
    assert blk == list(range(len(names)))
    assert text.count("TD_BEGIN\n") == 1 and "/* TD_PROBE" not in text
    for anchor, _ in dict(sp.ESTEP_PROBES["edits"])["estep_kernel"]:
        with pytest.raises(SystemExit, match="estep_kernel"):
            sp.instrument(src.replace(anchor, "", 1), sp.ESTEP_PROBES)
