"""PyTorch/CUDA port of the CCM runtime (``repro`` is the JAX reference).

The package mirrors ``repro`` file for file; it imports ``torch``, numpy
and the standard library only.  Entry points (``init_lm``,
``params_from_numpy``, ``init_online_state``, ``init_cache``) place their
tensors on the CUDA device unless the caller passes ``device="cpu"``;
every other function follows the device of its input tensors.
"""
