"""Models of the port: the recsys family (FM, DeepFM, Wide&Deep, xDeepFM)
over the embedding-bag substrate, and the NN pieces they use."""
