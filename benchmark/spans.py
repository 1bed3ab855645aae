"""The program's spans and counters of the traced segment, for the
per-layer readers in ``metrics/``.

The port records spans while a ``torch.profiler`` capture runs
(``gym_pybullet_adrp_tpu_torch/utils/profiling.py``): the traced segment
records them and the timed window does not. A rollout is one root span
``rollout``; its children are ``rollout.draws`` (with
``draws.host_copies`` and the ``host_copies`` counter inside),
``race_rollout.launch``, ``rollout.account`` and ``rollout.flatten``.
Times are on the host's clock (``time.perf_counter_ns``).

``segment(ctx)`` gives the last ``ctx.trace["calls"]`` roots and every
span under them, or None: with no trace, with a program that has no
recorder (older checkouts), with no root recorded, or on any fault in
reading them. A reader of this module never raises.
"""

ROOT = "rollout"


class Segment:
    """The traced segment's roots and the spans under them."""

    def __init__(self, roots, spans):
        self.roots = roots
        self.spans = spans
        self.n = len(roots)

    def named(self, name):
        return [s for s in self.spans if s.name == name]

    def total_ms(self, name):
        """Summed duration (ms) of the spans ``name``, a rollout."""
        return sum(s.end - s.start for s in self.named(name)) / 1e6 / self.n

    def count(self, name):
        """The counter ``name`` summed over the roots and every span under
        them, a rollout."""
        return sum((s.counts or {}).get(name, 0)
                   for s in self.roots + self.spans) / self.n

    def self_ms(self):
        """The roots' own time (ms), less their direct children's, a
        rollout."""
        ids = {r.id for r in self.roots}
        child = sum(s.end - s.start for s in self.spans if s.parent in ids)
        own = sum(r.end - r.start for r in self.roots)
        return (own - child) / 1e6 / self.n


def _records():
    """The port's span records, or None where it has no recorder."""
    try:
        from gym_pybullet_adrp_tpu_torch.utils import profiling
        return profiling.records()
    except (ImportError, AttributeError):
        return None


def segment(ctx):
    if ctx.trace is None:
        return None
    try:
        recs = _records()
        if not recs:
            return None
        roots = sorted((r for r in recs
                        if r.name == ROOT and r.parent is None),
                       key=lambda r: r.start)[-int(ctx.trace["calls"]):]
        if not roots:
            return None
        ids = {r.id for r in roots}
        spans = [s for s in recs if s.root in ids and s.parent is not None]
        return Segment(roots, spans)
    except Exception as e:  # a reader never fails the run
        ctx.log(f"spans: not read ({type(e).__name__}: {e})")
        return None


def read_with(ctx, fn):
    """``fn(segment)``, or None where there is no segment."""
    seg = segment(ctx)
    return None if seg is None else fn(seg)
