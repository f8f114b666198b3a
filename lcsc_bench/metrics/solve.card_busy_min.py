"""solve.card_busy_min: the busy share of the least busy of a T-sharded
solve's cards over the profiled stretch, in %: each card's union of
device activities (``busy_s_by_card``; a card with none counts 0) over
the stretch.  A card that waits on its neighbours shows here, where the
union over the cards (``device_idle.solve``) hides it.  Where the trace
holds no device activity, nothing is read."""


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr["busy_s_by_card"]:
        return None
    cards = int(rec["config"]["mesh"]["shards"])
    busy = [tr["busy_s_by_card"].get(i, 0.0) for i in range(cards)]
    return 100.0 * min(busy) / tr["window_s"]
