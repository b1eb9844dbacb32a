"""End-to-end training example: thin wrapper over
``repro_torch.launch.train`` — train a reduced architecture for a few
hundred steps on the synthetic pipeline; the loss must drop well below
ln(vocab). Twin of the reference's ``examples/train_lm.py``; runs on the
card unless given ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch qwen3-0.6b --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch mamba2-2.7b --steps 50
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch qwen3-0.6b --device cpu

The weights are drawn from ``torch.Generator().manual_seed(0)``, so the
losses differ from the reference CLI's, whose weights come from
``jax.random``.
"""

from repro_torch.launch.train import main

if __name__ == "__main__":
    main()
