"""The plain reference: the classifiers of each family
(``families/<family>.py``), their training step and their eval forward
in plain PyTorch, float32 with TF32 off.

It imports neither JAX nor anything of the program under test, and takes
only the benchmark's inputs (``synth.py``): images, labels, weights and
the seeds of the draws.  Whatever the program derives from them (the
resident set's order, the sampler's windows, augmentation draws, folded
BatchNorm, dropout masks) is worked out here again.
"""
