"""Model layer: functional decoder + multimodal fusion on torch tensors."""
