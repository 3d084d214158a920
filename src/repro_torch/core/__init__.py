"""The port's core: the CommPlan IR (``comm``), named random streams
(``rng``), gradient compression (``compression``) and parameter-tree
helpers (``tree``). Unlike the JAX package's ``core/__init__``, importing
this package imports none of its modules."""
