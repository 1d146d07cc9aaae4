"""The admission gate's other two paths under the port's pipelined loop
on the recurrent and shared-prefix configs, against the JAX reference
(``tests/test_torch_pipelined_state.py`` holds the models, the drive
loop and the runs these cases share):

  * ``admit_chunk_tokens`` on these configs takes the unchunked branch
    (no chunk is dispatched): the same streams and accounting as the
    unchunked run;
  * the squeeze (``pool.squeeze``), pipelined, on reduced
    ``recurrentgemma-2b`` and ``xlstm-1.3b`` under one plan on both
    packages (``SQUEEZE``), on requests that all arrive at once and stay
    long enough to be preempted: a recurrent row preempted, its state page
    demoted to the host tier and fetched back bit for bit at its thaw,
    the ``serve.preempt`` events, preemptions, migrations, hits, misses
    and the tuner's history the reference's, the streams the reference's
    and the fault-free run's.  Two xlstm rows hold two state pages, so
    its plan squeezes to one."""
import pytest

from test_torch_pipelined_state import (ARCHS, RECURRENT, _accounting,
                                        _drive, _run)


@pytest.mark.parametrize("arch", ARCHS)
def test_admit_chunk_tokens_takes_the_unchunked_branch(arch):
    """``admit_chunk_tokens=4`` on a recurrent or prefix config: every
    admission prefills whole (no chunk is dispatched, no "admit" stage),
    with the unchunked run's streams and accounting."""
    got = _drive("port", arch, chunk=4,
                 demote=arch == "xlstm-1.3b")
    want = _run("port", arch, "staggered")
    assert not got["rec"].events("serve.pipeline.admit_chunk")
    stages = {e["stage"] for e in got["rec"].events("serve.pipeline.stage")}
    assert "admit" not in stages
    assert got["streams"] == want["streams"]
    assert _accounting(got) == _accounting(want)


@pytest.mark.parametrize("arch", RECURRENT)
def test_squeeze_preempts_a_recurrent_row_and_thaws_it(arch):
    """Under ``SQUEEZE``'s plan the pipelined loop preempts a recurrent
    row: its state page is demoted to the host tier and fetched back bit
    for bit after its thaw, with no second prefill.  The ``serve.preempt``
    events, preemptions, migrations, hits, misses, the tuner's history
    and the streams are the reference's under the same plan, and the
    streams the fault-free run's."""
    ref, port = _run("ref", arch, "squeeze"), _run("port", arch, "squeeze")
    free = _run("port", arch, "long")
    b = port["b"]
    assert b.preemptions >= 1, "the squeeze must preempt a row"
    assert b.preemptions == ref["b"].preemptions
    key = lambda rec: [{k: e[k] for k in ("step", "rid", "pages",
                                          "hbm_need", "hbm_cap")}
                       for e in rec.events("serve.preempt")]
    assert key(port["rec"]) == key(ref["rec"])
    assert all(e["pages"] >= 1 for e in key(port["rec"]))
    counters = port["rec"].summary()["counters"]
    assert counters["serve.thawed"] == b.preemptions, "every one thaws"
    assert counters["serve.admitted"] == 4, "a thaw is never a prefill"
    assert port["pages"].demoted >= b.preemptions
    assert port["pages"].fetched == port["pages"].demoted
    assert port["streams"] == ref["streams"] == free["streams"]
    want, got = _accounting(ref), _accounting(port)
    for k in ("migrations", "hits", "misses", "moved", "history"):
        assert got[k] == want[k], k
    assert got["history"], "the tuner leaves its profile"
