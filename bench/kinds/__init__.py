"""The general code of the traffic mixes, one module a ``kind``: each has
``setup(ctx)``, ``window(ctx, state, seconds, w)`` and ``check(ctx, state,
measured)``, and reads its parameters from the mix's file."""
