"""The four-card cell ``olmo1b-sync-sgd-4chip`` on the CPU: four gloo ranks
of the port's replica mode at toy size, one replica each, on the cell's
own traffic file and limits. A clean run is correct; a run whose ranks
leave out the exchange between them (the partner's weights never cross a
rank) is not."""
import textwrap
import time

from portbench import toy
from portbench.kinds import train as K
from portbench.run import run_cell

NAME = "olmo1b-sync-sgd-4chip"
SEED = 2 ** 31 + 17


def _run():
    res, _ = run_cell(NAME, SEED, 0.2, False, device="cpu",
                      t_start=time.time(), cell=toy.toy_cell(NAME))
    return res


def test_four_card_cell_on_gloo_ranks_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 4 and res["attempted"] >= 1


def test_four_card_cell_without_the_exchange_is_not_correct(monkeypatch,
                                                            tmp_path):
    """Each rank process runs ``ranks.py`` with ``gossip.exchange`` (the
    replica group's send and receive) made the identity."""
    wrapper = tmp_path / "rank_without_exchange.py"
    wrapper.write_text(textwrap.dedent(f"""
        import runpy
        import sys
        sys.path[:0] = [{str(toy.ROOT)!r}, {str(toy.ROOT / "src")!r}]
        from repro_torch.core import async_gossip, gossip
        ident = lambda x, recv_from, group=None: x
        gossip.exchange = async_gossip.exchange = ident
        sys.argv = sys.argv[1:]
        runpy.run_path(sys.argv[0], run_name="__main__")
        """))
    popen = K.subprocess.Popen
    monkeypatch.setattr(
        K.subprocess, "Popen",
        lambda args, **kw: popen([args[0], str(wrapper), *args[1:]], **kw))
    res = _run()
    assert not res["correct"], res["checks"]
    assert res["checks"]["change_gap"]["value"] > 10 * res["checks"][
        "change_gap"]["limit"]
