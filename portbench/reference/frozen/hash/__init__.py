from .poseidon2 import DIGEST_WIDTH, RATE, WIDTH, poseidon2_permute, s_permute
