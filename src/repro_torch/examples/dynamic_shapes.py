"""Paper §7: planning with dynamically-sized tensors, multi-pass.

Scenario: an encoder with static shapes feeds a decoder whose buffer
sizes only become known after the first dynamic tensor is computed
(RNN-style). Plan in stages against ONE arena, never moving live buffers.
Twin of the reference's ``examples/dynamic_shapes.py``: pure planning,
no device.

    PYTHONPATH=src python -m repro_torch.examples.dynamic_shapes
"""

from __future__ import annotations

from repro_torch.core.dynamic import IncrementalPlanner
from repro_torch.core.records import TensorUsageRecord

MB = 2**20


def recs(triples, base_id):
    return [TensorUsageRecord(a, b, s, tensor_id=base_id + i)
            for i, (a, b, s) in enumerate(triples)]


def main() -> dict:
    """Plan the three stages; returns each stage's arena bytes and the
    staging overhead against a one-shot plan."""
    # stage 0: statically-known encoder intermediates
    inc = IncrementalPlanner()
    inc.extend(recs([(0, 1, 4 * MB), (1, 3, 2 * MB),
                     (2, 4, 2 * MB), (3, 5, 1 * MB)], base_id=0))
    stages = [inc.total_size]
    print(f"stage 0 (static): arena = {inc.total_size / MB:.2f} MiB")

    # stage 1: decoder lengths resolved at run time -> sizes now known
    inc.extend(recs([(5, 7, 3 * MB), (6, 8, 1 * MB)], base_id=100))
    stages.append(inc.total_size)
    print(f"stage 1 (+decoder): arena = {inc.total_size / MB:.2f} MiB")

    # stage 2: a second resolution point (e.g. beam width growth)
    inc.extend(recs([(8, 9, 2 * MB)], base_id=200))
    stages.append(inc.total_size)
    print(f"stage 2 (+beams):   arena = {inc.total_size / MB:.2f} MiB")
    overhead = inc.overhead_vs_oneshot()
    print(f"staging overhead vs one-shot plan: "
          f"{overhead:.3f}x "
          f"(1.0 = staging cost nothing)")
    return {"stage_bytes": stages, "overhead_vs_oneshot": overhead}


if __name__ == "__main__":
    main()
