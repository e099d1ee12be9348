"""Tokenizers of the port (char, bpe and rev_bpe) and the text language
id of the data pipeline (own copies of reverb_tpu/text/)."""
