"""Loop kinds, one module per kind, found by the name in a traffic file's
``loop`` key (``named.find("loops", ...)``); each module's ``Loop``
derives from ``perfbench.loop.Loop``, which says what a kind defines."""
