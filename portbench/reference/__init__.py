"""The benchmark's plain reference of a WNN proof of inference.

Plain Python and numpy that import nothing of the program: the model and its
exact scores (``wnn``), the circuit (``gadgets`` over ``cs``, ``expression``,
``assignment``, ``selectors``), the verifying key worked out again with the
SRS's trapdoor (``keygen``, ``pinned``), and the proof's check (``verifier``
over ``transcript``, ``domain``, ``bn254``, ``field``). Each module is a frozen
copy of the program's host code, named in its docstring, so that a later
change to the program cannot move the reference.
"""
