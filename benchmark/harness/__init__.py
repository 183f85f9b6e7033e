"""The benchmark's general code: it reads a cell's configuration, traffic
mix, driver, limits and per-layer readers from their own files by name
(`spec.py`), makes the inputs from the seed (`generator.py`, `scene.py`),
gives the drivers what they share (`windows.py`), reads the traced sub-window
(`profile.py`, `counting.py`) and decides `correct` against the plain
reference (`check.py`)."""
