"""End-to-end metrics, one module per metric, found by the metric's name
(``named.find("e2e", ...)``).  Each has ``reduce(steps, window_s, loop)``
over all the steps of the measured window: ``window_s`` runs from the
window's start to the end of the last completed step, and a step that was
running when ``--seconds`` elapsed is part of it.  ``setup_s`` is the
harness's own clock and has no module."""
