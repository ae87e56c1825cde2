"""k1_trees_share_pct: the TPOT trees' share of K1's time on the card
(%): the summed `k1.trees` durations (K1's own `%globaltimer` stamps,
read by the program's tracer) over the summed `k1.call` durations (a
call's entry to its last stamp). Nothing to read without the stamps:
off the card, or in a program without them."""


def read(view):
    spans = view.get("spans")
    if not spans or "k1.trees" not in spans or "k1.call" not in spans:
        return None
    call = spans["k1.call"]["total_s"]
    return 100.0 * spans["k1.trees"]["total_s"] / call if call > 0 else None
