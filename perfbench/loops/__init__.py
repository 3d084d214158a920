"""What drives the program for each kind of traffic mix; a mix names its
loop (``"loop"``). A loop module holds ``Loop(ctx)``, whose constructor is
the set-up, ``step(i)``, ``boundary(units)``, ``window_metrics``,
``counters``, ``attempted``, ``outputs`` and ``release``; and
``check(ctx, outputs)`` and ``control(ctx, outputs, variant)``, which
compare what the program produced (or, for the control, a lower precision
or a planted fault in the reference put in its place) with the plain
reference."""
