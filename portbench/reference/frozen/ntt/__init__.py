from .ntt import coset_lde, intt, ntt
