"""The port's native host layer: the boundary codec (``hostcodec.c``), the
C++ greedy oracle and host leadership pass (``greedy.cpp``), and their
build (``build.py``)."""
