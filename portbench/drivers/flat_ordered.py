"""Traffic driver ``flat-ordered``: ``flat.py``'s flat tiled ForceAtlas
steps, run as they stand, over the configuration's graph relabelled in
the program's partition order: ``graph.reorder.partition_order`` at the
traffic's ``order_coarsening_factor`` (the device coarsener on a
card-only graph), then ``graph.reorder.apply_order``.  The order is made
in set-up, before the window; ``flat.py``'s check holds the steps to
``reference/flat_step.py`` on the same relabelled arrays.
"""

from __future__ import annotations

import dataclasses

from portbench import harness
from portbench.drivers import flat
from portbench.program import program_graph


class OrderedContext(harness.Context):
    """A run's context whose ``graph()`` is the configuration's graph in
    partition order: {"n", "senders", "receivers"} sorted by (sender,
    receiver), on the device.  The first call orders it (``perm``:
    new id -> old id) and keeps a host copy that later calls return."""

    perm = None
    _host = None

    def graph(self) -> dict:
        if self._host is None:
            from graph_embed_tpu_torch.graph.reorder import (apply_order,
                                                             partition_order)

            g = program_graph(super().graph())
            self.perm = partition_order(
                g, self.traffic["order_coarsening_factor"])
            ordered, _ = apply_order(g, self.perm)
            del g
            self._host = (ordered.n, ordered.senders.cpu(),
                          ordered.receivers.cpu())
            return {"n": ordered.n, "senders": ordered.senders,
                    "receivers": ordered.receivers}
        n, s, r = self._host
        return {"n": n, "senders": s.to(self.device),
                "receivers": r.to(self.device)}


def ordered(ctx: harness.Context) -> OrderedContext:
    return OrderedContext(**{f.name: getattr(ctx, f.name)
                             for f in dataclasses.fields(ctx)})


def run(ctx: harness.Context) -> harness.Run:
    return flat.run(ordered(ctx))
