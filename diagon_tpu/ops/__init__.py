"""Device ops: bit unpacking, phase-1 approximate scoring, top-k.

Plain XLA implementations live here; Pallas kernels for the GPU are in
``diagon_tpu/ops/pallas``, each tested against its plain form.
"""
