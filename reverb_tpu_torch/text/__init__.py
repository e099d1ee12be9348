"""Tokenizers of the port: char, bpe and rev_bpe (own copies of
reverb_tpu/text/)."""
