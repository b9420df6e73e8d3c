"""Set-up: from the first line of ``run.py`` to the window's start
(imports, kernel loads, weights, engine or train state, warm-up and the
warm-up traffic the cell needs), host clock."""


def read(run):
    return run.setup_s
