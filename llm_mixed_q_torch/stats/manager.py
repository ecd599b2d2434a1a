"""StatManager: named collections of activation and weight statistics
(counterpart of the JAX package's ``stats/manager.py``; reference
stat_manager.py:7-154). The models report their nodes through
``llm_mixed_q_torch.ops.linear.capture_quant_node_taps`` in place of the
reference's forward hooks, and the manager routes each entry into its
collection. A weight entry is taken once (the reference's
``weight_collect_updated`` guard, stat_manager.py:110-128)."""

from __future__ import annotations

from .stats import StatBase, create_new_stat


def _create_stats(stats) -> list[StatBase]:
    """Stat objects from a list of names or a dict of name -> kwargs."""
    if isinstance(stats, dict):
        return [create_new_stat(name, **kwargs) for name, kwargs in stats.items()]
    return [create_new_stat(name) for name in stats]


class _StatCollection:
    def __init__(self, stats):
        self.stats: list[StatBase] = _create_stats(stats)

    def compute(self) -> dict:
        results = {}
        for stat in self.stats:
            results.update(stat.export())
        return results


class ActStatCollection(_StatCollection):
    def update(self, batch):
        for stat in self.stats:
            # one sample at a time, its batch axis kept (reference
            # stat_manager.py:19-27)
            for i in range(batch.shape[0]):
                stat.update_a_sample(batch[i : i + 1])


class WeightStatCollection(_StatCollection):
    def update(self, weight):
        for stat in self.stats:
            stat.update_a_sample(weight)


class StatManager:
    def __init__(self, act_stats, weight_stats):
        self.act_stats = act_stats
        self.weight_stats = weight_stats
        self.registered_stats: dict[str, ActStatCollection | WeightStatCollection] = {}
        self.weight_collect_updated: dict[str, bool] = {}

    def _act(self, name: str) -> ActStatCollection:
        if name not in self.registered_stats:
            self.registered_stats[name] = ActStatCollection(self.act_stats)
        return self.registered_stats[name]

    def _weight(self, name: str) -> WeightStatCollection:
        if name not in self.registered_stats:
            self.registered_stats[name] = WeightStatCollection(self.weight_stats)
            self.weight_collect_updated[name] = False
        return self.registered_stats[name]

    def update_act(self, name: str, batch):
        self._act(name).update(batch)

    def update_weight(self, name: str, weight):
        col = self._weight(name)
        if not self.weight_collect_updated[name]:
            col.update(weight)
            self.weight_collect_updated[name] = True

    def finalize(self, show_progress_bar: bool = False) -> dict:
        """Each statistic's result (``show_progress_bar`` accepted and
        ignored, as in the JAX package)."""
        return {name: stat.compute() for name, stat in self.registered_stats.items()}
