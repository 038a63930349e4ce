from .expression import (
    Expr, Constant, FixedQuery, AdviceQuery, InstanceQuery, Sum, Product, Scaled,
)
from .cs import ConstraintSystem, Column, Selector, TableColumn
from .assignment import Assignment, Cell
from .mock import MockProver
from .keygen import keygen, VerifyingKey, ProvingKey
from .prover import create_proof, Drbg
from .verifier import verify_proof

__all__ = [
    "Expr", "Constant", "FixedQuery", "AdviceQuery", "InstanceQuery", "Sum",
    "Product", "Scaled", "ConstraintSystem", "Column", "Selector",
    "TableColumn", "Assignment", "Cell", "MockProver",
    "keygen", "VerifyingKey", "ProvingKey", "create_proof", "Drbg",
    "verify_proof",
]
