from ccmh_torch.tokenizer.bpe import ClipBpeTokenizer, tokenize_batch

__all__ = ["ClipBpeTokenizer", "tokenize_batch"]
