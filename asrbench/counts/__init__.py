"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the models' FLOPs (`flops.py`), the kernels' least
operations and bytes and the card's peaks (`bounds.py`)."""
