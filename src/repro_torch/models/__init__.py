"""Models of the port: the recsys family (FM, DeepFM, Wide&Deep, xDeepFM)
over the embedding-bag substrate, the decoder-only transformer family
(dense GQA and MoE), and the NN pieces they use."""
