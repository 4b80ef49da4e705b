"""The decoupled look-back of lookback.cuh modelled in numpy, for the
CPU models of the single-pass kernels (K7 hstep_epilogue in
test_torch_epilogue.py; K8 resident_compact and K11 fullsort_dedup in
test_torch_compact.py): 64-bit status words tagged with the call's
epoch, the look-back a warp of 32 lanes reading a tile each a round,
and tiles taking tickets in the order they start and then advancing in
a random interleaving (a tile whose look-back meets an unpublished word
yields and reads again).  One Workspace serves every call of a test,
so words of earlier calls (older epochs, more tiles) are present."""

WARP = 32
INVALID, AGGREGATE, INCLUSIVE = 0, 1, 2


def word(epoch, state, payload):
    return ((epoch << 2 | state) << 32) | payload


def state_of(w, epoch):
    hi = w >> 32
    return hi & 3 if hi >> 2 == epoch else INVALID


class Workspace:
    """The status words and the epoch counter one device keeps."""

    def __init__(self):
        self.status = {}        # name -> list of words (grows, never reset)
        self.epoch = 0

    def words(self, name, tiles):
        w = self.status.setdefault(name, [])
        w.extend([0] * (tiles - len(w)))
        return w

    def next_epoch(self):
        self.epoch += 1
        return self.epoch


def look_back(status, tile, epoch, agg):
    """lookback.cuh look_back as a generator: lane l of the warp reads
    tile end - 1 - l; yields while a word it needs is unpublished;
    returns the exclusive prefix."""
    if tile == 0:
        status[0] = word(epoch, INCLUSIVE, agg)
        return 0
    status[tile] = word(epoch, AGGREGATE, agg)
    excl, end = 0, tile
    while True:
        sums, inclusive = [], []
        for lane in range(WARP):
            p = end - 1 - lane
            if p < 0:
                w = word(epoch, INCLUSIVE, 0)
            else:
                while state_of(status[p], epoch) == INVALID:
                    yield
                w = status[p]
            sums.append(w & 0xFFFFFFFF)
            inclusive.append(state_of(w, epoch) == INCLUSIVE)
        if any(inclusive):
            excl += sum(sums[:inclusive.index(True) + 1])
            break
        excl += sum(sums)
        end -= WARP
    status[tile] = word(epoch, INCLUSIVE, excl + agg)
    return excl


def run_tiles(ntiles, body, rng):
    """Start tiles in ticket order at random moments and advance the
    started ones in a random interleaving until all finish."""
    live, started = [], 0
    while started < ntiles or live:
        if started < ntiles and (not live or rng.random() < 0.3):
            live.append(body(started))
            started += 1
            continue
        g = live[rng.integers(len(live))]
        try:
            next(g)
        except StopIteration:
            live.remove(g)
