"""End-to-end serving example: thin wrapper over
``repro_torch.launch.serve`` — batched requests against a model with the
paper's memory planner reporting the decode-step footprint, the slot log
and its audit. Twin of the reference's ``examples/serve_lm.py``; runs on
the card unless given ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mamba2-2.7b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch qwen3-0.6b --full
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mamba2-2.7b --device cpu

The weights are drawn from ``--seed`` by ``torch.Generator``, so the
tokens differ from the reference CLI's, whose weights come from
``jax.random``.
"""

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
