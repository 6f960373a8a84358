from .challenger import DuplexChallenger
from .merkle import MerkleTree
