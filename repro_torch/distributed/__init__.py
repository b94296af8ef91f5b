"""Distribution substrate for the LM path (``repro.distributed``'
counterpart): ``compression``, the int8 error-feedback gradient
reduction over a ``torch.distributed`` group.  The JAX package's
``sharding`` (logical axes onto a mesh) and ``pipeline`` (the GPipe
schedule over a mesh axis) belong with the mesh (ROADMAP A17f)."""
